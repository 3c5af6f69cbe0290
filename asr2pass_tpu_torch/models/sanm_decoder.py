"""Paraformer parallel decoder in FunASR block order, offline and
streaming.

Counterpart of the JAX package's models/sanm_decoder.py (`apply`,
`init_caches`, `apply_streaming`). Non-autoregressive: the
CIF acoustic embeddings [B, U, D] are refined by N blocks and projected
to vocab logits in one parallel pass. Block math (FunASR
DecoderLayerSANM):

    h = ffn(norm1(x))                 # feed-forward FIRST
    m = fsmn(norm2(h))                # depthwise memory conv, inner residual
    x = x + m                         # single residual from the block input
    x = x + cross_attn(norm3(x), enc)

then the `decoders3` tail block (norm1 -> ffn, NO residual), the optional
hotword cross block, and after_norm -> output projection. The streaming
pass carries each block's FSMN cache, one [L, B, kernel-1, D] tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from asr2pass_tpu_torch.config import DecoderConfig
from asr2pass_tpu_torch.models.layers import (
    CrossAttention,
    Dense,
    Ffn,
    Fsmn,
    LayerNorm,
    cross_attention,
    ffn,
    fsmn_apply,
    fsmn_apply_cached,
    layer_norm,
    vocab_head,
)
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, d_model: int, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(d_model, device=device)
        self.ffn = Ffn(d_model, cfg.linear_units, **kw)
        self.ln2 = LayerNorm(d_model, device=device)
        self.fsmn = Fsmn(d_model, cfg.kernel_size, **kw)
        self.ln3 = LayerNorm(d_model, device=device)
        self.cross = CrossAttention(d_model, d_model, cfg.attention_heads,
                                    **kw)


class SanmDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, d_model: int, vocab_size: int,
                 use_hotword: bool = False, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.blocks = nn.ModuleList(DecoderBlock(cfg, d_model, **kw)
                                    for _ in range(cfg.num_blocks))
        self.tail = nn.ModuleDict({
            "ln1": LayerNorm(d_model, device=device),
            "ffn": Ffn(d_model, cfg.linear_units, **kw)})
        self.after_norm = LayerNorm(d_model, device=device)
        self.out = Dense(d_model, vocab_size, **kw)
        self.hotword = (nn.ModuleDict({
            "ln": LayerNorm(d_model, device=device),
            "cross": CrossAttention(d_model, d_model, cfg.attention_heads,
                                    **kw)}) if use_hotword else None)

    def forward(self, ac_embeds, enc, enc_mask=None, mask=None,
                hw_emb=None, hw_mask=None):
        return apply(self, ac_embeds, enc, enc_mask, mask, hw_emb, hw_mask,
                     cfg=self.cfg)


def _fsmn_left(params, cfg: Optional[DecoderConfig]) -> int:
    """Left-context taps of the offline path: sanm_shift None means fully
    causal; converted FunASR models carry sanm_shift in their config."""
    kernel = params.blocks[0].fsmn.taps.shape[0]
    if cfg is None or cfg.sanm_shift is None:
        return kernel - 1
    return (kernel - 1) // 2 + cfg.sanm_shift


def _block(layer, x, enc, enc_mask, mask, heads, cache=None,
           fsmn_left=None, valid_len=None):
    # FunASR DecoderLayerSANM: ffn first, one residual spanning ffn+fsmn
    h = ffn(layer.ffn, layer_norm(layer.ln1, x))
    h = layer_norm(layer.ln2, h)
    if cache is not None:
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        m, new_cache = fsmn_apply_cached(layer.fsmn, h, cache, valid_len)
    else:
        new_cache = None
        m = fsmn_apply(layer.fsmn, h, mask, left=fsmn_left)
    x = x + m
    x = x + cross_attention(layer.cross, layer_norm(layer.ln3, x), enc,
                            heads, enc_mask)
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    return x, new_cache


def _tail_and_head(params, x, mask, hw_emb, hw_mask, heads):
    # decoders3: ffn(norm1(x)) with NO residual
    x = ffn(params.tail["ffn"], layer_norm(params.tail["ln1"], x))
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    if hw_emb is not None and params.hotword is not None:
        x = x + cross_attention(params.hotword["cross"],
                                layer_norm(params.hotword["ln"], x),
                                hw_emb, heads, hw_mask)
    x = layer_norm(params.after_norm, x)
    return vocab_head(params.out, x)


def apply(params, ac_embeds, enc, enc_mask=None, mask=None, hw_emb=None,
          hw_mask=None, heads: int = 4,
          cfg: Optional[DecoderConfig] = None,
          block_span: Optional[str] = None):
    """Offline pass. ac_embeds: [B, U, D] CIF embeddings; enc: [B, T, D].
    Returns logits [B, U, vocab]. block_span: the runtime/metrics span
    around each block (None: none)."""
    if cfg is not None:
        heads = cfg.attention_heads
    left = _fsmn_left(params, cfg)
    x = ac_embeds
    for layer in params.blocks:
        with METRICS.stage(block_span):
            x, _ = _block(layer, x, enc, enc_mask, mask, heads,
                          fsmn_left=left)
    return _tail_and_head(params, x, mask, hw_emb, hw_mask, heads)


def init_caches(params, batch: int) -> torch.Tensor:
    """Zero FSMN caches [L, B, kernel-1, D] on the params' device."""
    kernel, d = params.blocks[0].fsmn.taps.shape
    return torch.zeros(len(params.blocks), batch, kernel - 1, d,
                       dtype=torch.float32,
                       device=params.blocks[0].fsmn.taps.device)


def apply_streaming(params, ac_embeds, enc, caches, enc_mask=None,
                    mask=None, valid_len=None, hw_emb=None, hw_mask=None,
                    heads: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk pass with the FSMN cache carry [L, B, kernel-1, D]: the
    causal offline pass when the chunks are concatenated. valid_len [B]
    is the true token count of each stream of a padded chunk."""
    x = ac_embeds
    new_caches = []
    for layer, cache in zip(params.blocks, caches):
        x, nc = _block(layer, x, enc, enc_mask, mask, heads, cache=cache,
                       valid_len=valid_len)
        new_caches.append(nc)
    return (_tail_and_head(params, x, mask, hw_emb, hw_mask, heads),
            torch.stack(new_caches))
