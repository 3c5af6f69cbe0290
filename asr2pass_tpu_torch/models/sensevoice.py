"""SenseVoice-small: multilingual (zh/en/ja/ko/yue) non-autoregressive CTC
model with meta prefix tokens.

Counterpart of the JAX package's models/sensevoice.py (init, apply,
greedy_ids). Role of sensevoice-small.cpp: the offline forward takes
[feats, len, language-id, textnorm-id] (:596-642) and the decoder strips
the first 4 meta outputs (language, emotion, event, textnorm; CTCSearch
:323-377). Four query embeddings (lid and textnorm chosen from per-option
tables, emotion and event fixed) are prepended to the features, the SAN-M
encoder runs over [meta | frames], a converted checkpoint's `tp` stack
(residual SAN-M blocks and a LayerNorm, FunASR's SenseVoiceEncoderSmall
tp_encoders/tp_norm) follows, and a CTC head gives vocab logits.

The encoder's T is the feature bucket + 4, so its self-attention reaches
the kernels (ops/attention.py) at T = 260, 516, 1028 (#1), 2052, 3076
(#2) and 5124 (#3); batch padding rows have 4 valid positions, the meta.
A model that parallel/sharding.shard_params cut runs tensor-parallel:
H/tp heads a rank, the CTC head's vocab columns sharded. Its logits stay
sharded: greedy_ids takes the whole vocab's argmax from each rank's
column maxima, the sharded CTC prune (parallel/ctc_shard) exchanges only
candidates, and whole_logits gathers them where a consumer needs every
column.
"""
from __future__ import annotations

import re
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from asr2pass_tpu_torch.config import SenseVoiceConfig
from asr2pass_tpu_torch.models import sanm_encoder
from asr2pass_tpu_torch.models.layers import (Dense, LayerNorm, layer_norm,
                                              length_mask, vocab_head)
from asr2pass_tpu_torch.parallel.comm import (all_gather, gather_from_tp,
                                              group_rank, tp_group)
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.utils import resolve_device

NUM_META = 4  # lid, emotion, event, textnorm prefix positions


class TpStack(nn.Module):
    """The tp_encoders stack: `rest` residual SAN-M layers at the model
    width, then `norm`."""

    def __init__(self, cfg, n_blocks: int, generator=None, device=None):
        super().__init__()
        self.rest = nn.ModuleList(
            sanm_encoder.EncoderLayer(cfg.output_size, cfg, generator, device)
            for _ in range(n_blocks))
        self.norm = LayerNorm(cfg.output_size, device=device)


class SenseVoice(nn.Module):
    def __init__(self, cfg: SenseVoiceConfig, n_lid: Optional[int] = None,
                 n_tn: Optional[int] = None, tp_blocks: int = 0,
                 generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.encoder.input_size
        n_lid = n_lid or max(cfg.lid_dict.values()) + 1
        n_tn = n_tn or max(cfg.textnorm_dict.values()) + 1

        def normal(*shape):
            w = torch.empty(shape, device=device)
            return nn.Parameter(w.normal_(generator=generator) * 0.02)

        self.encoder = sanm_encoder.SanmEncoder(cfg.encoder, generator,
                                                device)
        self.lid_embed = normal(n_lid, d_in)
        self.tn_embed = normal(n_tn, d_in)
        self.query_embed = normal(2, d_in)
        self.ctc = Dense(cfg.encoder.output_size, cfg.vocab_size,
                         generator=generator, device=device)
        self.tp = (TpStack(cfg.encoder, tp_blocks, generator, device)
                   if tp_blocks else None)

    def forward(self, feats, lengths, lid_ids, tn_ids):
        return apply(self, self.cfg, feats, lengths, lid_ids, tn_ids)


def init(cfg: SenseVoiceConfig, generator: Optional[torch.Generator] = None,
         device="cuda", tp_blocks: int = 0) -> SenseVoice:
    """Random weights with the shapes and distributions of the JAX init;
    tp_blocks > 0 adds a tp stack of that depth (a converted
    SenseVoiceSmall carries 20). The generator must live on `device`."""
    dev = resolve_device(device)
    with torch.no_grad():
        return SenseVoice(cfg, tp_blocks=tp_blocks, generator=generator,
                          device=dev)


def from_state_dict(state_dict: Mapping[str, torch.Tensor],
                    cfg: SenseVoiceConfig, device="cuda") -> SenseVoice:
    """Inference model on `device` holding `state_dict` (as
    model_zoo.load_svs_bundle returns it). The meta tables' row counts
    come from the weights (a converted checkpoint shares one table for
    both), and the tp stack exists iff the weights carry it."""
    dev = resolve_device(device)
    tp_blocks = len({m.group(1) for k in state_dict
                     if (m := re.match(r"tp\.rest\.(\d+)\.", k))})
    model = SenseVoice(cfg, n_lid=state_dict["lid_embed"].shape[0],
                       n_tn=state_dict["tn_embed"].shape[0],
                       tp_blocks=tp_blocks, device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval().requires_grad_(False)


class SenseVoiceOutput(NamedTuple):
    # [B, 4+T, V]; a tensor-parallel model's: this rank's [B, 4+T, V/tp]
    # columns, rank r's [r V/tp, (r+1) V/tp), over tp_group
    logits: torch.Tensor
    lengths: torch.Tensor    # [B] valid positions incl. meta
    tp_group: Optional[object] = None


def encode(params: SenseVoice, cfg: SenseVoiceConfig, feats, lengths,
           lid_ids, tn_ids):
    """The encoder (and tp stack) over [meta | frames]: (enc [B, 4+T, D],
    valid lengths incl. meta [B])."""
    b, t, d_in = feats.shape
    lid = params.lid_embed[lid_ids][:, None, :].to(feats.dtype)
    tn = params.tn_embed[tn_ids][:, None, :].to(feats.dtype)
    queries = params.query_embed[None].expand(b, 2, d_in).to(feats.dtype)
    x = torch.cat([lid, queries, tn, feats], dim=1)
    full_len = lengths + NUM_META
    mask = length_mask(full_len, t + NUM_META)
    heads = cfg.encoder.attention_heads
    enc = sanm_encoder.apply(params.encoder, x, mask,
                             d_model=cfg.encoder.output_size, heads=heads,
                             block_span="asr.block")
    if params.tp is not None:
        for layer in params.tp.rest:
            with METRICS.stage("asr.block"):
                enc = sanm_encoder._block(layer, enc, mask, heads,
                                          residual=True)
        enc = layer_norm(params.tp.norm, enc)
    return enc, full_len


def apply(params: SenseVoice, cfg: SenseVoiceConfig, feats, lengths,
          lid_ids, tn_ids) -> SenseVoiceOutput:
    """feats: [B, T, lfr_dim]; lengths, lid_ids, tn_ids: [B] (int64).
    A tensor-parallel model's logits are its rank's vocab columns
    (SenseVoiceOutput.tp_group set)."""
    enc, full_len = encode(params, cfg, feats, lengths, lid_ids, tn_ids)
    group = tp_group(params.ctc)
    return SenseVoiceOutput(logits=vocab_head(params.ctc, enc,
                                              gather=False),
                            lengths=full_len, tp_group=group)


def whole_logits(out: SenseVoiceOutput) -> torch.Tensor:
    """[B, 4+T, V]: a tensor-parallel output's columns all-gathered."""
    return gather_from_tp(out.logits, -1, out.tp_group)


def vocab_argmax(out: SenseVoiceOutput) -> torch.Tensor:
    """[B, 4+T] argmax over the whole vocab, the first of equal maxima.
    Tensor-parallel, each rank's column maximum and its global id are
    all-gathered ([B, 4+T] each) and the first rank holding the largest
    wins: the lowest id, as the whole vocab's argmax picks."""
    if out.tp_group is None:
        return out.logits.argmax(dim=-1)
    idx = out.logits.argmax(dim=-1, keepdim=True)
    val = out.logits.gather(-1, idx)
    idx = idx + group_rank(out.tp_group) * out.logits.shape[-1]
    vals = all_gather(val, -1, out.tp_group)
    idxs = all_gather(idx, -1, out.tp_group)
    return idxs.gather(-1, vals.argmax(dim=-1, keepdim=True))[..., 0]


def greedy_ids(out: SenseVoiceOutput, blank_id: int = 0):
    """Greedy CTC on the device: argmax, repeat collapse, blank and meta
    strip, so a caller fetches [B, U] ids instead of the [B, T, V] logits
    (16 x 1028 x 25055 fp32 is 1.65 GB). Mirrors decode/ctc.ctc_greedy(
    skip_first=NUM_META), the CTCSearch semantics of
    sensevoice-small.cpp:323-377.

    Returns (ids [B, L-NUM_META] int64, counts [B], meta [B, NUM_META])
    where meta holds the argmax of the lang/emotion/event/textnorm
    positions; ids past a row's count are 0."""
    lengths = out.lengths
    am = vocab_argmax(out)                                   # [B, L]
    b, l = am.shape
    t_idx = torch.arange(l, device=am.device)[None, :]
    prev = torch.cat([torch.full((b, 1), -1, dtype=am.dtype,
                                 device=am.device), am[:, :-1]], dim=1)
    # the host greedy starts fresh at skip_first: no dedup vs a meta frame
    prev = torch.where(t_idx == NUM_META, -1, prev)
    keep = ((t_idx >= NUM_META) & (t_idx < lengths[:, None])
            & (am != blank_id) & (am != prev))
    u = l - NUM_META
    # kept tokens compact to the left; dropped frames all land in a spare
    # column u, which is sliced off. Those writes collide, and scatter_
    # on CUDA leaves the winner of a collision unspecified: harmless only
    # because the column is discarded. Kept positions never collide.
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, u)
    ids = torch.zeros((b, u + 1), dtype=am.dtype, device=am.device)
    ids.scatter_(1, pos, am)
    counts = keep.sum(dim=1)
    return ids[:, :u], counts, am[:, :NUM_META]
