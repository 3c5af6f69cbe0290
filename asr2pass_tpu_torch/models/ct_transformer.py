"""CT-Transformer punctuation model, offline and streaming (VadMask).

Counterpart of the JAX package's models/ct_transformer.py (FunASR
CTTransformer): token embedding -> the SAN-M encoder of
models/sanm_encoder.py (sqrt(d) scale, 1-based sinusoidal position
encoding, blocks, after_norm) -> linear class head. The streaming
variant passes a [T, T] VadMask so that already punctuated cache tokens
cannot attend to new text; that extra mask keeps attention on the plain
branch (ops/attention.use_flash), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import EncoderConfig, PuncConfig
from asr2pass_tpu_torch.models import sanm_encoder
from asr2pass_tpu_torch.models.layers import (
    Dense,
    Embedding,
    dense,
    embedding,
    length_mask,
)
from asr2pass_tpu_torch.utils import resolve_device


def _enc_cfg(cfg: PuncConfig) -> EncoderConfig:
    return EncoderConfig(input_size=cfg.embed_dim, output_size=cfg.att_dim,
                         num_blocks=cfg.num_blocks,
                         attention_heads=cfg.attention_heads,
                         linear_units=cfg.linear_units,
                         kernel_size=cfg.kernel_size)


class CtTransformer(nn.Module):
    def __init__(self, cfg: PuncConfig, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.embed_dim, **kw)
        self.encoder = sanm_encoder.SanmEncoder(_enc_cfg(cfg), **kw)
        self.out = Dense(cfg.att_dim, cfg.num_classes, **kw)

    def forward(self, ids, lengths=None, att_mask=None):
        return apply(self, self.cfg, ids, lengths, att_mask)


def init(cfg: PuncConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> CtTransformer:
    """Random weights with the shapes and distributions of the JAX init.
    The generator must live on `device`."""
    dev = resolve_device(device)
    with torch.no_grad():
        return CtTransformer(cfg, generator=generator, device=dev)


def from_state_dict(state_dict, cfg: PuncConfig,
                    device="cuda") -> CtTransformer:
    """Inference model on `device` holding `state_dict`."""
    dev = resolve_device(device)
    model = CtTransformer(cfg, device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def apply(params, cfg: PuncConfig, ids, lengths=None, att_mask=None):
    """ids: [B, T] token ids -> [B, T, num_classes] logits. att_mask:
    [B, T, T] or [T, T] (the VadMask of the streaming variant)."""
    t = ids.shape[1]
    x = embedding(params.embed, ids)
    mask = None if lengths is None else length_mask(lengths, t)
    h = sanm_encoder.apply(params.encoder, x, mask, d_model=cfg.att_dim,
                           heads=cfg.attention_heads, att_mask=att_mask)
    return dense(params.out, h)


def vad_mask(size: int, vad_pos: int) -> np.ndarray:
    """[T, T] mask, 1 = may attend. Rows 0..vad_pos-2 (cache tokens)
    cannot attend to columns >= vad_pos (new text)."""
    m = np.ones((size, size), dtype=np.float32)
    if 0 < vad_pos < size:
        m[: vad_pos - 1, vad_pos:] = 0.0
    return m
