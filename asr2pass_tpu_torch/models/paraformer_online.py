"""Streaming Paraformer: one batched chunk step over explicit state.

Counterpart of the JAX package's models/paraformer_online.py. Every
per-stream cache (the [lookback+lookahead] feature window, the absolute
position, the CIF (integrate, frame) remainder, the decoder's per-layer
FSMN caches) is a tensor with the streams on a leading axis, in an
`OnlineState` on the model's device, so S concurrent streams advance
through one `step` per 600 ms chunk.

Chunk geometry (chunk_size = [lookback, center, lookahead] = [5,10,5]
LFR frames): each step consumes `center` new feature frames; the
attention window is [cache(lookback+lookahead) | new(center)]; CIF
alphas are masked to the emit region so every global frame fires once:
  non-final: window positions [lookback, lookback + C)
  final:     window positions [lookback, lookback + lookahead + C) + tail

The params are a Paraformer module (models/paraformer.py): the streaming
model has the offline model's parameter tree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
from asr2pass_tpu_torch.models.layers import length_mask


class OnlineState(NamedTuple):
    feats_cache: torch.Tensor    # [B, lookback+lookahead, lfr_dim]
    pos: torch.Tensor            # [B] absolute LFR frame index consumed
    cif_integrate: torch.Tensor  # [B]
    cif_frame: torch.Tensor      # [B, D]
    dec_caches: torch.Tensor     # [L, B, lorder, D] stacked FSMN caches


def init_state(params, cfg: ParaformerConfig, batch: int) -> OnlineState:
    """Zero state for `batch` streams on the params' device."""
    dev = next(params.parameters()).device
    cache_len = cfg.chunk_size[0] + cfg.chunk_size[2]
    d = cfg.encoder.output_size
    return OnlineState(
        feats_cache=torch.zeros(batch, cache_len, cfg.frontend.lfr_dim,
                                dtype=torch.float32, device=dev),
        pos=torch.zeros(batch, dtype=torch.int32, device=dev),
        cif_integrate=torch.zeros(batch, dtype=torch.float32, device=dev),
        cif_frame=torch.zeros(batch, d, dtype=torch.float32, device=dev),
        dec_caches=sanm_decoder.init_caches(params.decoder, batch),
    )


def _posenc_batch(pos_start, length: int, depth: int):
    """Per-stream absolute sinusoidal position encoding [B, length,
    depth]."""
    dev = pos_start.device
    log_inc = math.log(10000.0) / (depth // 2 - 1)
    inv = torch.exp(torch.arange(depth // 2, dtype=torch.float32,
                                 device=dev) * -log_inc)
    positions = (pos_start[:, None].float()
                 + torch.arange(1, length + 1, dtype=torch.float32,
                                device=dev)[None, :])
    scaled = positions[:, :, None] * inv[None, None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


@torch.inference_mode()
def step(params, cfg: ParaformerConfig, state: OnlineState, new_feats,
         new_count, is_final) -> Tuple[OnlineState, torch.Tensor,
                                       torch.Tensor]:
    """One streaming chunk for all streams.

    new_feats: [B, C, lfr_dim] right-padded new LFR+CMVN frames; new_count:
    [B] valid new frames; is_final: [B] bool final-flush flags, all on the
    params' device. Returns (new_state, token_ids [B, U], counts [B])."""
    lookback, center, lookahead = cfg.chunk_size
    cache_len = lookback + lookahead
    b, c, lfr_dim = new_feats.shape
    d = cfg.encoder.output_size
    dev = new_feats.device

    # scale and absolute position encoding on the new frames only. The
    # window is scaled by sqrt(d) here and again inside sanm_encoder.apply,
    # as in the JAX package (a difference of the reference, kept)
    fmask = length_mask(new_count, c)
    x = new_feats * math.sqrt(d) + _posenc_batch(state.pos, c, lfr_dim)
    x = x * fmask[..., None]

    window = torch.cat([state.feats_cache, x], dim=1)     # [B, W, lfr]
    w = window.shape[1]
    wlen = cache_len + new_count
    wmask = length_mask(wlen, w)

    # the network runs in the params' dtype; the state stays fp32
    pdt = next(params.parameters()).dtype
    enc = sanm_encoder.apply(params.encoder, window.to(pdt), wmask,
                             add_posenc=False, d_model=d,
                             heads=cfg.encoder.attention_heads)

    alphas = cif.alphas_head(params.predictor, enc, cfg.predictor, wmask)
    # emit-region mask; window position p holds global frame (pos -
    # cache_len + p), so on early chunks the positions before frame 0
    # (the zero-initialised cache) never fire
    ar = torch.arange(w, device=dev)[None, :]
    hi = torch.where(is_final, cache_len + new_count, lookback + new_count)
    lo = torch.clamp(cache_len - state.pos, min=lookback)
    emit = (ar >= lo[:, None]) & (ar < hi[:, None])
    alphas = alphas * emit.float()
    # tail fire on final streams: one extra slot
    tail_a = torch.where(is_final, cfg.predictor.tail_threshold, 0.0)
    alphas_ext = torch.cat([alphas, tail_a[:, None].to(alphas.dtype)], dim=1)
    hidden_ext = torch.cat([enc, enc.new_zeros(b, 1, d)], dim=1)

    frames, counts, _, cif_state = cif.fire(
        hidden_ext, alphas_ext, cfg.predictor.threshold,
        cif.CifState(integrate=state.cif_integrate, frame=state.cif_frame))

    tok_mask = length_mask(counts, frames.shape[1])
    logits, new_caches = sanm_decoder.apply_streaming(
        params.decoder, frames, enc, state.dec_caches, enc_mask=wmask,
        mask=tok_mask, valid_len=counts, heads=cfg.decoder.attention_heads)
    ids = logits.argmax(dim=-1)

    # next feats cache = the last (lookback+lookahead) valid window frames
    idx = ((wlen[:, None] - cache_len)
           + torch.arange(cache_len, device=dev)[None, :]).clamp_min(0)
    new_cache = torch.take_along_dim(window, idx.long()[..., None], dim=1)

    # final streams reset their state for the next utterance
    fin = is_final
    zero = init_state(params, cfg, b)
    new_state = OnlineState(
        feats_cache=torch.where(fin[:, None, None], zero.feats_cache,
                                new_cache),
        pos=torch.where(fin, zero.pos, (state.pos + new_count).int()),
        cif_integrate=torch.where(fin, zero.cif_integrate,
                                  cif_state.integrate.float()),
        cif_frame=torch.where(fin[:, None], zero.cif_frame,
                              cif_state.frame.float()),
        dec_caches=torch.where(fin[None, :, None, None], zero.dec_caches,
                               new_caches.float()),
    )
    return new_state, ids, counts
