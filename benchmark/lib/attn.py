"""Attention calls of the traced window: each call into the program's
attention entry points (the unsplit-projection kernel, the split-head
kernels and the plain branch, as models/layers.py reaches them) runs
inside a "bench.attn" profiler range and is recorded with its shapes and
masks. Its bound is the least time the card could take for the work the
masks leave: the larger of 4 x q rows x keys x width operations over the
peak of its type and the bytes of q, k, v and the output read or written
once over the HBM bandwidth. The same work is counted whichever kernel,
or none, runs it.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

from benchmark.lib import chip, trace


class Calls:
    def __init__(self):
        self.calls: List[tuple] = []
        self.q_mask = None   # the decoder's token mask while it runs

    def _record(self, dtype, tq: int, tk: int, width: int, kv_mask):
        self.calls.append((dtype, tq, tk, width, kv_mask, self.q_mask))

    def bound_s(self) -> float:
        """The sum of every recorded call's bound."""
        total = 0.0
        for dtype, tq, tk, width, kv_mask, q_mask in self.calls:
            lk = (kv_mask > 0).sum(-1).double().cpu()
            if q_mask is not None:      # the decoder's tokens
                lq = (q_mask > 0).sum(-1).double().cpu()
            elif tq == tk:              # self-attention: the same rows
                lq = lk
            else:
                lq = torch.full_like(lk, tq)
            esize = torch.tensor([], dtype=dtype).element_size()
            ops = float((4 * lq * lk * width).sum())
            nbytes = float((esize * width * (2 * lq + 2 * lk)).sum())
            peak = chip.PEAK_FLOPS[str(dtype).replace("torch.", "")]
            total += max(ops / peak, nbytes / chip.HBM_BYTES_S)
        return total


@contextlib.contextmanager
def recording():
    """Wrap the entry points for the block; yields the Calls."""
    from asr2pass_tpu_torch.models import layers, sanm_decoder

    rec = Calls()
    mh, split, plain = (layers.mh_flash_attention, layers.flash_attention,
                        layers.attention_plain)
    dec = sanm_decoder.apply

    def mh_call(q, kv, kv_mask, heads):
        rec._record(q.dtype, q.shape[1], kv.shape[1], q.shape[2], kv_mask)
        with torch.profiler.record_function(trace.ATTN):
            return mh(q, kv, kv_mask, heads)

    def split_call(q, k, v, mask):
        rec._record(q.dtype, q.shape[2], k.shape[2],
                    q.shape[1] * q.shape[3], mask)
        with torch.profiler.record_function(trace.ATTN):
            return split(q, k, v, mask)

    def plain_call(q, k, v, kv_mask, *a, **kw):
        rec._record(q.dtype, q.shape[2], k.shape[2],
                    q.shape[1] * q.shape[3], kv_mask)
        with torch.profiler.record_function(trace.ATTN):
            return plain(q, k, v, kv_mask, *a, **kw)

    def dec_call(params, ac_embeds, enc, enc_mask=None, mask=None, *a, **kw):
        rec.q_mask = mask
        try:
            return dec(params, ac_embeds, enc, enc_mask, mask, *a, **kw)
        finally:
            rec.q_mask = None

    layers.mh_flash_attention, layers.flash_attention = mh_call, split_call
    layers.attention_plain = plain_call
    sanm_decoder.apply = dec_call
    try:
        yield rec
    finally:
        layers.mh_flash_attention, layers.flash_attention = mh, split
        layers.attention_plain = plain
        sanm_decoder.apply = dec
