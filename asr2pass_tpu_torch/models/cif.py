"""CIF (continuous integrate-and-fire) predictor.

Counterpart of the JAX package's models/cif.py: a conv + linear + sigmoid head
gives per-frame firing weights `alphas`; the integrate-and-fire pass
accumulates weighted encoder frames and emits one acoustic embedding per
threshold crossing, packed to the front of a [B, max_tokens, D] buffer.
The bicif timestamp head (3x transposed conv, BLSTM) gives the upsampled
alphas the timestamps are read from.

The JAX package runs the two integrate passes as lax.scan (XLA, not
Pallas); here they are Python loops over T with the same per-step
arithmetic, so fires are exact when fed the same alphas. The streaming
pass carries (integrate, frame) across chunks in a CifState, so
streaming equals offline when fed the same alphas.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from asr2pass_tpu_torch.config import PredictorConfig
from asr2pass_tpu_torch.models.layers import Dense, Lstm, dense, lstm_apply


class Conv(nn.Module):
    """Full (not depthwise) conv taps w [kernel, d_in, d_out], bias b;
    w ~ N(0, 1) * scale."""

    def __init__(self, kernel: int, d_in: int, d_out: int, scale: float,
                 generator=None, device=None):
        super().__init__()
        w = torch.empty((kernel, d_in, d_out), device=device)
        self.w = nn.Parameter(w.normal_(generator=generator) * scale)
        self.b = nn.Parameter(torch.zeros(d_out, device=device))


class CifPredictor(nn.Module):
    def __init__(self, cfg: PredictorConfig, generator=None, device=None):
        super().__init__()
        kernel = cfg.l_order + cfg.r_order + 1
        kw = dict(generator=generator, device=device)
        self.conv = Conv(kernel, cfg.idim, cfg.idim,
                         1.0 / math.sqrt(kernel * cfg.idim), **kw)
        self.out = Dense(cfg.idim, 1, **kw)
        if cfg.use_timestamp:
            self.us_cnn = Conv(cfg.upsample_times, cfg.idim, cfg.idim,
                               1.0 / math.sqrt(cfg.idim), **kw)
            half = cfg.idim // 2
            self.blstm = nn.ModuleDict({"fw": Lstm(cfg.idim, half, **kw),
                                        "bw": Lstm(cfg.idim, half, **kw)})
            self.us_out = Dense(cfg.idim, 1, **kw)


def _context_conv(p, x, l_order: int, r_order: int):
    kernel = l_order + r_order + 1
    pad = F.pad(x, (0, 0, l_order, r_order))
    t = x.shape[1]
    out = None
    for k in range(kernel):
        y = pad[:, k: k + t, :] @ p.w[k].to(x.dtype)
        out = y if out is None else out + y
    return out + p.b.to(x.dtype)


def alphas_head(params, enc, cfg: PredictorConfig, mask=None):
    """Encoder output [B, T, D] -> firing weights [B, T]:
    relu(conv(x) + x) -> linear -> sigmoid -> relu(a*smooth - noise),
    masked."""
    h = torch.relu(_context_conv(params.conv, enc, cfg.l_order,
                                 cfg.r_order) + enc)
    a = torch.sigmoid(dense(params.out, h))[..., 0]
    a = torch.relu(a * cfg.smooth_factor - cfg.noise_threshold)
    if mask is not None:
        a = a * mask
    return a


def upsampled_alphas(params, enc, cfg: PredictorConfig, mask=None,
                     token_num=None):
    """Timestamp (bicif) head: [B, T, D] -> us_alphas [B, T*upsample]:
    relu(conv(enc)) (shared conv, no residual), 3x transposed conv, BLSTM,
    linear+sigmoid, relu(a*smooth2 - noise2), masked, then rescaled to sum
    to token_num per row."""
    b, t, d = enc.shape
    up = cfg.upsample_times
    h = torch.relu(_context_conv(params.conv, enc, cfg.l_order, cfg.r_order))
    # transposed conv with stride == kernel == upsample_times
    y = torch.einsum("btd,kde->btke", h, params.us_cnn.w.to(h.dtype))
    y = y.reshape(b, t * up, d) + params.us_cnn.b.to(h.dtype)
    fw = lstm_apply(params.blstm["fw"], y)
    bw = lstm_apply(params.blstm["bw"], y.flip(1)).flip(1)
    y = torch.cat([fw, bw], dim=-1)
    a = torch.sigmoid(dense(params.us_out, y))[..., 0]
    a = torch.relu(a * cfg.smooth_factor2 - cfg.noise_threshold2)
    if mask is not None:
        a = a * mask.repeat_interleave(up, dim=-1)
    if token_num is not None:
        total = a.sum(dim=-1, keepdim=True).clamp_min(1e-6)
        a = a * (token_num.float()[:, None] / total)
    return a


class CifState(NamedTuple):
    """Streaming carry across chunks."""

    integrate: torch.Tensor  # [B]
    frame: torch.Tensor      # [B, D] weighted accumulation since last fire


def zero_state(batch: int, d: int, device=None) -> CifState:
    return CifState(
        integrate=torch.zeros(batch, dtype=torch.float32, device=device),
        frame=torch.zeros(batch, d, dtype=torch.float32, device=device))


def fire(hidden, alphas, threshold: float,
         state: Optional[CifState] = None,
         max_tokens: Optional[int] = None):
    """Integrate-and-fire. hidden [B, T, D], alphas [B, T] (zero where
    masked), state: the carry of the previous chunk (default zeros).
    Returns (frames [B, max_tokens, D] fired embeddings packed to the
    front, counts [B], fires [B, T] bool, new_state).

    max_tokens bounds the token buffer (default T); fires past it land in
    a guard slot that is dropped, and counts saturate at max_tokens."""
    b, t, d = hidden.shape
    if max_tokens is None:
        max_tokens = t
    if state is None:
        state = zero_state(b, d, hidden.device)
    integ, frame = state.integrate, state.frame
    fires, frames = [], []
    for i in range(t):
        alpha, h = alphas[:, i], hidden[:, i]
        new_integ = integ + alpha
        fired = new_integ >= threshold
        dist = torch.where(fired, threshold - integ, alpha)
        # one fused multiply-add, as XLA contracts frame + dist * h, so the
        # packed frames are bit-equal to the JAX package's
        out_frame = torch.addcmul(frame, dist[:, None], h)
        integ = torch.where(fired, new_integ - threshold, new_integ)
        frame = torch.where(fired[:, None],
                            (new_integ - threshold)[:, None] * h, out_frame)
        fires.append(fired)
        frames.append(out_frame)
    fires = torch.stack(fires, dim=1)
    frames = torch.stack(frames, dim=1)
    # pack fired frames to the front of the token axis
    idx = torch.cumsum(fires.long(), dim=1) - 1
    idx = torch.where(fires, idx.clamp_max(max_tokens), max_tokens)
    packed = torch.zeros(b, max_tokens + 1, d, dtype=hidden.dtype,
                         device=hidden.device)
    rows = torch.arange(b, device=hidden.device)[:, None].expand(b, t)
    packed.index_put_((rows, idx),
                      (frames * fires[..., None]).to(packed.dtype),
                      accumulate=True)
    counts = fires.long().sum(dim=1).clamp_max(max_tokens)
    return (packed[:, :max_tokens], counts, fires,
            CifState(integrate=integ, frame=frame))


def fire_offline(hidden, alphas, threshold: float, tail_threshold: float,
                 max_tokens: Optional[int] = None, lengths=None):
    """Offline fire with the tail alpha appended. With `lengths` [B] the
    tail alpha lands at each row's first padding position and hidden is
    zeroed from there on, so the tail fire flushes the remainder without
    adding content, for every row of a padded batch."""
    b, t, d = hidden.shape
    hidden_ext = torch.cat(
        [hidden, hidden.new_zeros(b, 1, d)], dim=1)
    if lengths is None:
        alphas_ext = torch.cat(
            [alphas, alphas.new_full((b, 1), tail_threshold)], dim=1)
    else:
        tail_pos = lengths.long().clamp_max(t)
        alphas_ext = F.pad(alphas, (0, 1))
        rows = torch.arange(b, device=alphas.device)
        alphas_ext[rows, tail_pos] = alphas_ext[rows, tail_pos] + tail_threshold
        valid = (torch.arange(t + 1, device=hidden.device)[None, :]
                 < tail_pos[:, None])
        hidden_ext = hidden_ext * valid[..., None].to(hidden_ext.dtype)
    frames, counts, fires, _ = fire(hidden_ext, alphas_ext, threshold,
                                    max_tokens=max_tokens)
    return frames, counts, fires


def peaks_from_alphas(us_alphas, threshold: float = 1.0):
    """us_cif_peak: the pre-reset integrate trace; a value >= threshold
    marks a fire. Callers pass threshold - 1e-4 (the timestamp reader
    tests peak > 1 - 1e-4)."""
    b, t = us_alphas.shape
    integ = torch.zeros(b, dtype=torch.float32, device=us_alphas.device)
    trace = []
    for i in range(t):
        new = integ + us_alphas[:, i]
        integ = torch.where(new >= threshold, new - threshold, new)
        trace.append(new)
    if not trace:
        return us_alphas.new_zeros(b, 0)
    return torch.stack(trace, dim=1)
