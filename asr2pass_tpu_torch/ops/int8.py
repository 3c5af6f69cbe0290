"""Exact int8 x int8 -> int32 products for the w8a8 dense layers.

The JAX package takes this product with jnp.dot(..., preferred_element_type
=int32) outside any Pallas kernel (its models/layers.py:50-60), so the port
takes a library call: on a CUDA tensor torch._int_mm, which runs on the
card's int8 tensor cores; on a CPU tensor the plain int32 product.

torch._int_mm refuses some shapes: it needs more than 16 rows, and the
inner and output widths a multiple of 8. The dense layers meet shapes that
break this (the predictor's 1-wide heads, the decoder's 8404-wide output
layer, the BLSTM's per-step product at B <= 16 rows). int8_matmul pads
such operands with zeros to the nearest legal shape and slices the
result: zero rows and columns add nothing to an integer sum, so the
result equals the unpadded product exactly. A weight is padded once, by
pad_weight (models/layers.Dense keeps that form beside its int8 weight);
only the activation rows are padded at each call.

The second operand is taken column-major (pad_weight's form):
torch._int_mm then runs a CUTLASS "tn" tensor-op kernel, where a row-major
one gets a WMMA kernel several times slower on the H100 (PERF.md, phase
11a).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm's shape rules on CUDA (checked in PyTorch's Blas.cpp)
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8

# _int_mm launches by (m, k, n) as the caller gave them, so a run can show
# which shapes went through the library call, padded or not
_LAUNCHES = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_shape(m: int, k: int, n: int) -> tuple:
    """The legal (m, k, n) that torch._int_mm is given for an m x k by
    k x n product."""
    return (max(m, INT_MM_MIN_ROWS), _round_up(k, INT_MM_MULTIPLE),
            _round_up(n, INT_MM_MULTIPLE))


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact."""
    return a.to(torch.int32) @ b.to(torch.int32)


def column_major(b: torch.Tensor) -> torch.Tensor:
    """b [K, N] with column-major strides (the same values)."""
    return b if b.stride(0) == 1 else b.t().contiguous().t()


def pad_weight(b: torch.Tensor) -> torch.Tensor:
    """b [K, N] int8 -> the operand torch._int_mm takes for it: column-major,
    zero-padded to the legal inner and output widths of int_mm_shape (b
    itself where it is column-major and legal)."""
    k, n = b.shape
    _, kp, np_ = int_mm_shape(INT_MM_MIN_ROWS, k, n)
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return column_major(b)


def int_mm_padded(a: torch.Tensor, b: torch.Tensor, n: int | None = None
                  ) -> torch.Tensor:
    """torch._int_mm of a [M, K] and b: a [K, N] weight, or pad_weight's
    form of one whose first n columns are wanted (default all). a is
    zero-padded to b's rows and to the legal row count; the result is
    sliced back to [M, n]."""
    m, k = a.shape
    n = b.shape[1] if n is None else n
    b = pad_weight(b)
    mp = max(m, INT_MM_MIN_ROWS)
    if (mp, b.shape[0]) != (m, k):
        a = F.pad(a, (0, b.shape[0] - k, 0, mp - m))
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def int8_matmul(a: torch.Tensor, b: torch.Tensor, n: int | None = None
                ) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact. b may also be
    pad_weight's form of a [K, n] weight (its first K rows and n columns
    are the operand). A CUDA tensor goes through int_mm_padded
    (torch._int_mm); a CPU tensor takes int8_matmul_plain."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_matmul takes 2-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    k = a.shape[1]
    n = b.shape[1] if n is None else n
    if tuple(b.shape) not in ((k, n), int_mm_shape(INT_MM_MIN_ROWS, k, n)[1:]):
        raise ValueError(f"int8_matmul: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (n={n}) is not [M, K] @ [K, N] "
                         "or its padded form")
    if not a.is_cuda:
        return int8_matmul_plain(a, b[:k, :n])
    y = int_mm_padded(a, b, n)
    shape = (a.shape[0], k, n)
    _LAUNCHES[shape] = _LAUNCHES.get(shape, 0) + 1
    return y


def launch_shapes() -> dict:
    """{(m, k, n): torch._int_mm calls} since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
