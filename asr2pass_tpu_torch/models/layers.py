"""Building blocks: small nn.Modules that hold the weights, and plain
functions on tensors that do the math.

Counterpart of the JAX package's models/layers.py. Each module keeps the JAX
package's parameter names and layouts (Dense keeps the [d_in, d_out]
weight), so a JAX parameter tree becomes this package's state dict by a
rename (runtime/model_zoo.params_from_jax). Each function takes its
module where the JAX function takes its parameter dict, so the two read
side by side.

Architecture notes: SAN-M attention is multi-head self-attention plus an
FSMN "memory" branch (a depthwise conv over the value projections with an
inner residual) added to the attention output. Attention over a segment
of MIN_T..MAX_T_SS frames on a CUDA tensor runs the hand-written kernel
(ops/attention.py); shorter segments and CPU tensors run the plain
branch, which is the JAX package's XLA branch.

Tensor parallelism: a module that parallel/sharding.shard_params cut to
one rank's shard carries its group (comm.tp_group), and the same
functions then run the rank's part and issue the collectives GSPMD
derives in the JAX package: attention over the rank's H/tp heads (the
kernels see those heads only) and the FFN's hidden slice, each entered
through comm.copy_to_tp and left through comm.reduce_from_tp with the
bias added once after the sum; SAN-M's FSMN memory, channel-sharded
with v, is all-gathered and added after the sum as well, so at tp = 1
every sum is the unsharded one. vocab_head gathers a vocab-sharded
head's logits to the whole vocabulary.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asr2pass_tpu_torch.ops.attention import (
    _merge_heads,
    _split_heads,
    attention_plain,
    flash_attention,
    mh_flash_attention,
    use_flash,
    use_flash_cross,
    use_flash_split,
)
from asr2pass_tpu_torch.ops.int8 import (column_major, int8_matmul,
                                         pad_weight)
from asr2pass_tpu_torch.parallel.comm import (copy_to_tp, gather_from_tp,
                                              group_rank, group_size,
                                              reduce_from_tp, tp_group)
from asr2pass_tpu_torch.utils import div_127, quantize_weight


def _uniform(shape, scale: float, generator, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-scale, scale, generator=generator)


# ---------------------------------------------------------------------------
# modules (weights only; the math is in the functions below)
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """Affine map in the JAX layout: w [d_in, d_out], optional b [d_out].
    Init: w ~ U(-1/sqrt(d_in), 1/sqrt(d_in)), b = 0.

    Quantized (utils.quantize_params) it holds, in place of w, the int8
    buffer w_q (w8a8) or w_q8 (w8a16) of the same shape and the float
    parameter scale [d_out]; weight_key names the form. w_q is kept
    column-major (ops/int8.column_major), the layout torch._int_mm is
    fast on, also after a load_state_dict; where its widths are not ones
    torch._int_mm takes, the non-persistent buffer w_q_mm holds it padded
    once (ops/int8.pad_weight)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 generator=None, device=None):
        super().__init__()
        self.weight_key = "w"
        self.w = nn.Parameter(_uniform((d_in, d_out), 1.0 / math.sqrt(d_in),
                                       generator, device))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device)) if bias
                  else None)

    @property
    def weight(self) -> torch.Tensor:
        """The weight in its stored form ([d_in, d_out], float or int8)."""
        return getattr(self, self.weight_key)

    def set_quantized(self, key: str, w_q: torch.Tensor,
                      scale: torch.Tensor) -> None:
        """Hold w_q under `key` ("w_q" or "w_q8") and scale instead of w."""
        if key not in ("w_q", "w_q8") or w_q.dtype != torch.int8:
            raise ValueError(f"no quantized form {key!r} of dtype "
                             f"{w_q.dtype}")
        delattr(self, self.weight_key)
        self.weight_key = key
        self.register_buffer(key, w_q)
        self.scale = nn.Parameter(scale, requires_grad=False)
        if key == "w_q":
            _w_q_layouts(self)
            self.register_load_state_dict_post_hook(_w_q_layouts)

    def quantize_(self, weight_only: bool = False) -> None:
        w_q, scale = quantize_weight(self.w.detach())
        self.set_quantized("w_q8" if weight_only else "w_q", w_q, scale)

    def forward(self, x):
        return dense(self, x)


def _w_q_layouts(module, incompatible_keys=None) -> None:
    """w_q column-major, and w_q_mm its padded form where it needs one."""
    module.w_q = column_major(module.w_q)
    w_mm = pad_weight(module.w_q)
    if w_mm is not module.w_q:
        module.register_buffer("w_q_mm", w_mm, persistent=False)


def quantized_like(model: nn.Module, state_dict) -> nn.Module:
    """Give each Dense of `model` the form its entry in `state_dict` has
    (w, w_q or w_q8), with empty tensors of those shapes on the meta
    device, so that load_state_dict(state_dict, assign=True) fills it."""
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense):
            continue
        prefix = f"{name}." if name else ""
        for key in ("w_q", "w_q8"):
            if prefix + key in state_dict:
                mod.set_quantized(
                    key,
                    torch.empty_like(state_dict[prefix + key], device="meta"),
                    torch.empty_like(state_dict[prefix + "scale"],
                                     device="meta"))
    return model


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, device=device))
        self.b = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return layer_norm(self, x)


class Fsmn(nn.Module):
    """Depthwise memory taps [kernel, d], no bias; U(+-1/sqrt(kernel))."""

    def __init__(self, d: int, kernel: int, generator=None, device=None):
        super().__init__()
        self.taps = nn.Parameter(_uniform((kernel, d),
                                          1.0 / math.sqrt(kernel),
                                          generator, device))


class Embedding(nn.Module):
    """Token table [vocab, d] ~ N(0, 1) * 0.02 (embedding_init's)."""

    def __init__(self, vocab: int, d: int, generator=None, device=None):
        super().__init__()
        table = torch.empty((vocab, d), device=device)
        self.table = nn.Parameter(table.normal_(generator=generator) * 0.02)

    def forward(self, ids):
        return embedding(self, ids)


class SanmAttention(nn.Module):
    def __init__(self, d_in: int, d: int, heads: int, kernel: int,
                 generator=None, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(d_in, 3 * d, generator=generator, device=device)
        self.out = Dense(d, d, generator=generator, device=device)
        self.fsmn = Fsmn(d, kernel, generator=generator, device=device)

    def forward(self, x, mask=None, att_mask=None):
        return sanm_attention(self, x, self.heads, mask, att_mask)


class CrossAttention(nn.Module):
    def __init__(self, d: int, d_mem: int, heads: int, generator=None,
                 device=None):
        super().__init__()
        self.heads = heads
        self.q = Dense(d, d, generator=generator, device=device)
        self.kv = Dense(d_mem, 2 * d, generator=generator, device=device)
        self.out = Dense(d, d, generator=generator, device=device)

    def forward(self, x, mem, mem_mask=None):
        return cross_attention(self, x, mem, self.heads, mem_mask)


class Ffn(nn.Module):
    def __init__(self, d: int, hidden: int, generator=None, device=None):
        super().__init__()
        self.w1 = Dense(d, hidden, generator=generator, device=device)
        self.w2 = Dense(hidden, d, generator=generator, device=device)

    def forward(self, x):
        return ffn(self, x)


class Lstm(nn.Module):
    """Gates i, f, g, o in that column order; `wh` has no bias."""

    def __init__(self, d_in: int, d_hidden: int, generator=None,
                 device=None):
        super().__init__()
        self.wx = Dense(d_in, 4 * d_hidden, generator=generator,
                        device=device)
        self.wh = Dense(d_hidden, 4 * d_hidden, bias=False,
                        generator=generator, device=device)

    def forward(self, xs):
        return lstm_apply(self, xs)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def dense(p, x):
    """Output dtype follows the input (bf16 on the serving path). Three
    forms, as in the JAX package's layers.py:47-75:
    - w_q (w8a8): each row of x is quantized to int8 with the scale
      max|row| (floored at 1e-6) / 127, the int8 product is taken exactly
      in int32 (ops/int8.int8_matmul: torch._int_mm on the card), cast to
      x's dtype and scaled by (row scale * column scale) in x's dtype;
    - w_q8 (w8a16): x @ w_q8 in x's dtype, times the column scale;
    - w: x @ w."""
    if p.weight_key == "w_q":
        a_scale = div_127(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6))
        x_q = torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)
        y = int8_matmul(x_q.reshape(-1, x.shape[-1]),
                        getattr(p, "w_q_mm", p.w_q), p.w_q.shape[1])
        y = y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
        y = y * (a_scale * p.scale).to(x.dtype)
    elif p.weight_key == "w_q8":
        y = (x @ p.w_q8.to(x.dtype)) * p.scale.to(x.dtype)
    else:
        y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def layer_norm(p, x, eps: float = 1e-5):
    """eps of torch nn.LayerNorm; statistics in fp32 even under bf16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * p.g + p.b
    return y.to(x.dtype)


def embedding(p, ids):
    return p.table[ids]


def sinusoidal_posenc(start: int, length: int, depth: int,
                      device=None) -> torch.Tensor:
    """Positions start+1 .. start+length (1-based), layout [sin | cos]
    over depth/2 timescales, scale -log(10000)/(depth/2-1)."""
    log_timescale_increment = math.log(10000.0) / (depth // 2 - 1)
    inv_timescales = torch.exp(
        torch.arange(depth // 2, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    positions = torch.arange(start + 1, start + length + 1,
                             dtype=torch.float32, device=device)
    scaled = positions[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def length_mask(lengths, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, T] float mask."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return (ar < lengths[:, None]).float()


def fsmn_apply(p, x, mask=None, left: Optional[int] = None):
    """Symmetric (encoder) or causal (decoder) depthwise memory conv.

    x: [B, T, D]; left = number of left-context taps (default centred).
    Inner residual: out = x + conv(x), masked before and after."""
    kernel = p.taps.shape[0]
    taps = p.taps.to(x.dtype)
    if left is None:
        left = (kernel - 1) // 2
    right = kernel - 1 - left
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    pad = F.pad(x, (0, 0, left, right))
    t = x.shape[1]
    out = torch.zeros_like(x)
    for k in range(kernel):
        out = out + pad[:, k: k + t, :] * taps[k]
    out = x + out
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    return out


def fsmn_apply_cached(p, x, cache, valid_len=None):
    """Causal FSMN step with a streaming cache. x: [B, T, D] right-padded,
    cache: [B, lorder, D], the last lorder valid frames of the stream.
    Returns (out, new_cache). With valid_len [B] the cache advances by
    exactly valid_len frames, so padding never reaches the state."""
    kernel = p.taps.shape[0]
    taps = p.taps.to(x.dtype)
    lorder = kernel - 1
    t = x.shape[1]
    ext = torch.cat([cache.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for k in range(kernel):
        out = out + ext[:, k: k + t, :] * taps[k]
    out = x + out
    if lorder == 0:
        return out, cache
    if valid_len is None:
        return out, ext[:, -lorder:, :]
    # cache rows = ext[valid_len + i] for i in [0, lorder)
    idx = valid_len.long()[:, None] + torch.arange(lorder,
                                                   device=x.device)[None, :]
    return out, torch.take_along_dim(ext, idx[..., None], dim=1)


def _ones_mask(x):
    return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)


def _score_dtype(x):
    """Scores in x's dtype when ASR2PASS_BF16_SCORES=1 (read at each call,
    as the JAX package's layers.py:256-265 reads it), else fp32."""
    return (x.dtype if os.environ.get("ASR2PASS_BF16_SCORES", "0") == "1"
            else torch.float32)


def _row_parallel(p, x, group, mem=None):
    """A row-parallel Dense: this rank's partial product, summed over the
    group, then the whole bias (and the all-gathered channel-sharded
    `mem`) added once, in the unsharded dense's order."""
    y = reduce_from_tp(x @ p.w.to(x.dtype), group)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    if mem is not None:
        y = y + gather_from_tp(mem, -1, group)
    return y


def sanm_attention(p, x, heads: int, mask=None, att_mask=None):
    """SAN-M self-attention. x: [B, T, Din]; mask: [B, T] padding mask;
    att_mask: [B, T, T] or [T, T] extra attention mask. Returns [B, T, D].

    Three branches, as in the JAX package: the unsplit-projection kernel
    (mh_flash_attention) for MIN_T <= T <= MAX_T_SS, the split-head
    kernels (flash_attention) past MAX_T_SS, both on CUDA tensors only;
    else the plain branch. A tensor-parallel module runs heads/tp of the
    heads (its qkv shard is [q_r | k_r | v_r])."""
    group = tp_group(p)
    x = copy_to_tp(x, group)
    heads //= group_size(group)
    qkv = dense(p.qkv, x)
    d = qkv.shape[-1] // 3
    d_k = d // heads
    kv_mask = mask if mask is not None else _ones_mask(x)

    if use_flash(x.shape[1], d_k, att_mask, x.is_cuda):
        # the kernel reads the q and k|v column blocks of the fused
        # projection in place: no split, transpose or merge is made
        mem = fsmn_apply(p.fsmn, qkv[..., 2 * d:], mask)
        ctx = mh_flash_attention(qkv[..., :d], qkv[..., d:], kv_mask, heads)
    else:
        q, k, v = qkv.split(d, dim=-1)
        mem = fsmn_apply(p.fsmn, v, mask)
        qh, kh, vh = (_split_heads(a, heads) for a in (q, k, v))
        if use_flash_split(x.shape[1], d_k, att_mask, x.is_cuda):
            ctx = flash_attention(qh, kh, vh, kv_mask)
        else:
            ctx = attention_plain(qh, kh, vh, kv_mask, att_mask=att_mask,
                                  score_dtype=_score_dtype(x))
        ctx = _merge_heads(ctx)
    if group is None:
        out = dense(p.out, ctx) + mem
    else:
        out = _row_parallel(p.out, ctx, group, mem)
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    return out


def cross_attention(p, x, mem, heads: int, mem_mask=None):
    """x: [B, T, D] queries; mem: [B, S, Dm] keys/values. Padded query
    rows are NOT zeroed (downstream token masks own that). A
    tensor-parallel module runs heads/tp heads."""
    group = tp_group(p)
    x, mem = copy_to_tp(x, group), copy_to_tp(mem, group)
    heads //= group_size(group)
    q = dense(p.q, x)
    kv = dense(p.kv, mem)
    d = q.shape[-1]
    d_k = d // heads
    kv_mask = mem_mask if mem_mask is not None else _ones_mask(mem)
    if use_flash_cross(x.shape[1], mem.shape[1], d_k, x.is_cuda):
        ctx = mh_flash_attention(q, kv, kv_mask, heads)
    else:
        k, v = kv.split(d, dim=-1)
        ctx = _merge_heads(attention_plain(
            _split_heads(q, heads), _split_heads(k, heads),
            _split_heads(v, heads), kv_mask))
    if group is None:
        return dense(p.out, ctx)
    return _row_parallel(p.out, ctx, group)


def ffn(p, x):
    group = tp_group(p)
    if group is None:
        return dense(p.w2, torch.relu(dense(p.w1, x)))
    h = torch.relu(dense(p.w1, copy_to_tp(x, group)))
    return _row_parallel(p.w2, h, group)


def vocab_head(p, x, gather: bool = True):
    """Logits of a vocab head (Dense [D, V]). Sharded over tp (its w
    [D, V/tp], its bias whole), the rank's columns are all-gathered to
    [..., V] and the bias added after; gather=False returns the rank's
    [..., V/tp] columns with their bias (the sharded CTC prune's
    input)."""
    group = tp_group(p)
    if group is None:
        return dense(p, x)
    y = copy_to_tp(x, group) @ p.w.to(x.dtype)
    if gather:
        return gather_from_tp(y, -1, group) + p.b.to(x.dtype)
    width = y.shape[-1]
    return y + p.b.narrow(0, group_rank(group) * width, width).to(x.dtype)


def lstm_apply(p, xs):
    """xs: [B, T, Din] -> outputs [B, T, H]; a loop over T. The input
    projection of all steps is one product taken before the loop."""
    b, t, _ = xs.shape
    # the width from the stored weight, whatever its form (the JAX
    # package's layers.py:335 reads w, which a quantized tree lacks)
    h_dim = p.wh.weight.shape[0]
    h = torch.zeros(b, h_dim, dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    gx = dense(p.wx, xs)
    hs = []
    for i in range(t):
        gates = gx[:, i] + dense(p.wh, h)
        g_i, g_f, g_g, g_o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(g_f) * c + torch.sigmoid(g_i) * torch.tanh(g_g)
        h = torch.sigmoid(g_o) * torch.tanh(c)
        hs.append(h)
    if not hs:
        return torch.zeros(b, 0, h_dim, dtype=torch.float32,
                           device=xs.device)
    return torch.stack(hs, dim=1)
