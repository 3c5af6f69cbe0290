"""Sequence-parallel SAN-M encoding for very long offline segments.

Counterpart of the JAX package's parallel/sequence.py. The TIME axis of
one padded batch is cut over the ranks of a mesh axis, rank r holding
frames [r t, (r+1) t) with t = T/n:

  * dense, FFN and LayerNorm are pointwise over time: local
  * attention: q stays local, k and v are all-gathered over the axis
    (memory O(T D) a rank); the score mask needs no gather, since every
    rank builds the whole [B, T] mask from the lengths
  * the FSMN memory conv needs (kernel-1)/2 frames of halo on each side,
    exchanged with the ring neighbours (comm.halo_exchange), zero at the
    sequence's ends

The attention here is the plain einsum-softmax-einsum of the JAX
package's shard_map body (sequence.py:64-88), not one of the kernels.
Padding semantics are JAX's: v is masked before the FSMN conv, the
attention output is not, and each block's output is masked. Every rank
calls with the same whole input and gets the same whole output.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from asr2pass_tpu_torch.config import EncoderConfig
from asr2pass_tpu_torch.models.layers import (dense, ffn, layer_norm,
                                              length_mask, sinusoidal_posenc)
from asr2pass_tpu_torch.ops.attention import (_merge_heads, _split_heads,
                                              attention_plain)
from asr2pass_tpu_torch.parallel.comm import (all_gather, group_rank,
                                              group_size, halo_exchange)


def _fsmn_halo(p, x, group):
    """Centred depthwise memory conv with cross-shard halos; inner
    residual."""
    kernel = p.taps.shape[0]
    left = (kernel - 1) // 2
    taps = p.taps.to(x.dtype)
    ext = halo_exchange(x, left, group)
    t = x.shape[1]
    out = torch.zeros_like(x)
    for k in range(kernel):
        out = out + ext[:, k: k + t, :] * taps[k]
    return x + out


def _attention_sp(p, x, heads: int, group, mask, gmask):
    """Local q against all-gathered k and v. mask: local [B, t]; gmask the
    whole [B, T]."""
    q, k, v = dense(p.qkv, x).chunk(3, dim=-1)
    v = v * mask[..., None].to(v.dtype)
    mem = _fsmn_halo(p.fsmn, v, group)
    kg = all_gather(k, 1, group)
    vg = all_gather(v, 1, group)
    ctx = attention_plain(_split_heads(q, heads), _split_heads(kg, heads),
                          _split_heads(vg, heads), gmask)
    return dense(p.out, _merge_heads(ctx)) + mem


def _block_sp(layer, x, heads, residual, group, mask, gmask):
    h = _attention_sp(layer.att, layer_norm(layer.ln1, x), heads, group,
                      mask, gmask)
    x = x + h if residual else h
    x = x + ffn(layer.ffn, layer_norm(layer.ln2, x))
    return x * mask[..., None].to(x.dtype)


def encode_sequence_parallel(params, feats: torch.Tensor, cfg: EncoderConfig,
                             mesh, axis: str = "sp",
                             lengths: Optional[Sequence[int]] = None
                             ) -> torch.Tensor:
    """[B, T, input_size] -> [B, T, d] with T cut over the mesh's `axis`
    (T must be a multiple of its size). lengths [B] masks right padding
    (serving pads long segments to a multiple of the axis); default all
    valid. params: a whole SanmEncoder (not tensor-parallel)."""
    group = mesh.get_group(axis)
    n, r = group_size(group), group_rank(group)
    b, t_all, d_in = feats.shape
    if t_all % n:
        raise ValueError(f"T={t_all} must be a multiple of the {axis} "
                         f"axis size {n}")
    t = t_all // n
    d_model = cfg.output_size
    heads = cfg.attention_heads
    if lengths is None:
        lengths = [t_all] * b
    gmask = length_mask(torch.as_tensor(list(lengths), device=feats.device),
                        t_all)
    mask = gmask[:, r * t: (r + 1) * t]
    x = feats[:, r * t: (r + 1) * t]
    # absolute positions of this shard
    pe = sinusoidal_posenc(r * t, t, d_in, device=feats.device)
    h = x * math.sqrt(d_model) + pe[None].to(x.dtype)
    h = _block_sp(params.first, h, heads, d_in == d_model, group, mask, gmask)
    for layer in params.rest:
        h = _block_sp(layer, h, heads, True, group, mask, gmask)
    return all_gather(layer_norm(params.after_norm, h), 1, group)
