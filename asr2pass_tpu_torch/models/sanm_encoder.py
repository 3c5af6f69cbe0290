"""SAN-M encoder, offline full-utterance mode.

Counterpart of the JAX package's models/sanm_encoder.py: input LFR+CMVN
features are scaled by sqrt(d_model), summed with the 1-based sinusoidal
position encoding, then N SAN-M blocks (self-attention + FSMN memory
branch + FFN, pre-norm residuals) and a final LayerNorm. Layer 0 (the
input-dim projection) is `first`; layers 1..N-1 are the ModuleList
`rest` (a stacked, scanned pytree in the JAX package).
"""
from __future__ import annotations

import math
from typing import Optional

from torch import nn

from asr2pass_tpu_torch.config import EncoderConfig
from asr2pass_tpu_torch.models.layers import (
    Ffn,
    LayerNorm,
    SanmAttention,
    ffn,
    layer_norm,
    length_mask,
    sanm_attention,
    sinusoidal_posenc,
)
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS


class EncoderLayer(nn.Module):
    def __init__(self, d_in: int, cfg: EncoderConfig, generator=None,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_in, device=device)
        self.att = SanmAttention(d_in, cfg.output_size, cfg.attention_heads,
                                 cfg.kernel_size, generator=generator,
                                 device=device)
        self.ln2 = LayerNorm(cfg.output_size, device=device)
        self.ffn = Ffn(cfg.output_size, cfg.linear_units,
                       generator=generator, device=device)


class SanmEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.first = EncoderLayer(cfg.input_size, cfg, generator, device)
        self.rest = nn.ModuleList(
            EncoderLayer(cfg.output_size, cfg, generator, device)
            for _ in range(1, cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.output_size, device=device)

    def forward(self, feats, mask=None):
        return apply(self, feats, mask, d_model=self.cfg.output_size,
                     heads=self.cfg.attention_heads)


def _block(layer, x, mask, heads, residual: bool, att_mask=None):
    h = sanm_attention(layer.att, layer_norm(layer.ln1, x), heads, mask,
                       att_mask)
    x = x + h if residual else h
    x = x + ffn(layer.ffn, layer_norm(layer.ln2, x))
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    return x


def apply(params, feats, mask=None, pos_start: int = 0,
          add_posenc: bool = True, d_model: Optional[int] = None,
          heads: int = 4, att_mask=None, block_span: Optional[str] = None):
    """feats: [B, T, input_size] LFR+CMVN features -> [B, T, d].
    block_span: the runtime/metrics span around each block (None: none)."""
    b, t, d_in = feats.shape
    if d_model is None:
        d_model = params.after_norm.g.shape[0]
    x = feats * math.sqrt(d_model)
    if add_posenc:
        x = x + sinusoidal_posenc(pos_start, t, d_in,
                                  device=feats.device)[None].to(x.dtype)
    # the first block adds its residual only when it keeps the width
    with METRICS.stage(block_span):
        x = _block(params.first, x, mask, heads,
                   residual=(d_in == d_model), att_mask=att_mask)
    for layer in params.rest:
        with METRICS.stage(block_span):
            x = _block(layer, x, mask, heads, residual=True,
                       att_mask=att_mask)
    return layer_norm(params.after_norm, x)


def apply_with_lengths(params, feats, lengths, **kw):
    mask = length_mask(lengths, feats.shape[1])
    return apply(params, feats, mask, **kw), mask
