"""Masked multi-head attention: a hand-written CUDA kernel on the card, a
plain PyTorch version for tensors on the CPU.

Counterpart of the JAX package's ops/attention.py. The JAX package has three
Pallas TPU kernels there; each entry point below keeps its JAX signature:

  mh_flash_attention(q, kv, kv_mask, heads)  replaces _mhss_kernel
      (attention.py:72-155): per-head attention straight off the UNSPLIT
      projections (q [B,Tq,D], kv [B,Tk,2D] with K columns then V
      columns, heads in contiguous d_k column blocks), merged-layout
      output, padded query rows not zeroed.
  _attention_ss(q, k, v, kv_mask, q_mask)    replaces _ss_kernel
      (attention.py:50-69,234-292): split-head [B,H,T,d], Tq != Tk
      allowed, rows whose q_mask is 0 are zeroed when q_mask is given.
      Reached through flash_attention (T <= MAX_T_SS_SPLIT) and
      cross_flash_attention.
  _attention_flash(q, k, v, mask)            replaces _kernel
      (attention.py:158-189,295-337): split-head, T > MAX_T_SS_SPLIT,
      fully masked rows come out as 0.

On a CUDA tensor all three launch one tensor-core kernel (wgmma fed by
TMA) per dtype: float32 the 3xTF32 kernel of csrc/attention_f32_sm90.cu,
bfloat16 the kernel of csrc/attention_sm90.cu; both take their tensor
maps from csrc/tma.cuh. Both read Q, K, V and write the output through
(batch, head, row) strides, so the unsplit layout needs no head split,
merge or copy (a view that TMA cannot address is copied, see plan_tma).
What bounds each and how it is designed is described at the top of its
source. On a CPU tensor each entry point runs its plain version (einsum,
masked fp32 softmax, einsum: the XLA-path semantics of the JAX
package's models/layers.py:258-267).
A CUDA tensor launches the kernel or raises; nothing falls back. The
kernels have no backward: a CUDA entry point refuses operands that need
a gradient while autograd is on (refuse_autograd).

Masking contract of all three (attention.py:34,69,189): masked scores are
the finite -1e30, never -inf, and the divide is by max(l, 1e-30), so a row
with no valid key (a batch-bucket padding row of length 0) is finite.

The kernels are compiled by nvcc from the checkout at first use into one
library in BUILD_DIR (git-ignored) and loaded with ctypes; see build().
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

_NEG = -1e30

# Dispatch thresholds, kept from the JAX package (attention.py:41,47,390).
# They were sized for TPU VMEM, not for this card; re-deriving them by
# measurement on the H100 is later work. They decide which entry point a
# segment length reaches, so each kernel is reached on the main path.
MIN_T = 256
MAX_T_SS = 2048
MAX_T_SS_SPLIT = 4096
# largest head dim of the gates (attention.py:390,404,415) and of the CUDA
# kernels, which run any d_head up to it
MAX_D_HEAD = 256

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the C symbol of the kernel for each input dtype, and its source
KERNELS = {
    torch.float32: ("asr2pass_attention_f32", "csrc/attention_f32_sm90.cu"),
    torch.bfloat16: ("asr2pass_attention_bf16", "csrc/attention_sm90.cu"),
}
_lib = None


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the attention kernels are compiled from "
            f"{CSRC} on a machine with the CUDA toolkit")
    return path


def sources() -> list:
    """The kernel sources (csrc/*.cu) and the header they share
    (csrc/*.cuh)."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def build() -> Path:
    """Compile every csrc/*.cu for sm_90a into one shared library in
    BUILD_DIR, once per content of all sources and headers, and return
    its path. Each .cu is compiled by its own nvcc, all started together,
    then linked. nvcc's ptxas reports (registers, shared memory, spills)
    are kept beside the library as a .log file."""
    digest = hashlib.sha1()
    for src in sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    srcs = [src for src in sources() if src.suffix == ".cu"]
    lib = BUILD_DIR / f"libattention_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC"]
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f".{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *arch, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    log, failed = [], []
    for src, proc in zip(srcs, procs):
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f".{tag}.so"
    res = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    lib.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, lib)   # atomic: a concurrent process never sees a half-written file
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, _ in KERNELS.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            smem = getattr(lib, f"{name}_smem")
            smem.argtypes = [ctypes.c_int]
            smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(dtype, d_head: int) -> int:
    """Dynamic shared memory of one block of dtype's kernel at d_head, as
    the kernel's source computes it."""
    return getattr(_library(), f"{kernel_symbol(dtype)}_smem")(d_head)


def kernel_symbol(dtype) -> str:
    """The C function that takes this input dtype: the 3xTF32 fp32
    kernel (csrc/attention_f32_sm90.cu) or the bf16 kernel
    (csrc/attention_sm90.cu)."""
    if dtype not in KERNELS:
        raise TypeError(f"attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return KERNELS[dtype][0]


def check_operands(q, k, v, out, kv_mask, q_mask) -> None:
    """Raise on what the kernels do not take. q/k/v/out are [B,H,T,d]
    views; kv_mask [B,Tk]; q_mask [B,>=Tq] or None."""
    kernel_symbol(q.dtype)
    for x in (k, v, out):
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError("q, k, v and out must share dtype and device")
    for x in (q, k, v, out):
        if x.stride(-1) != 1:
            raise ValueError("attention kernel needs unit column stride")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not 1 <= d <= MAX_D_HEAD:
        raise ValueError(f"attention kernel has no head dim {d} "
                         f"(takes 1 to {MAX_D_HEAD})")
    if (k.shape != v.shape or tuple(k.shape[:2]) != (b, h)
            or k.shape[3] != d or tuple(out.shape) != (b, h, tq, d)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and out {tuple(out.shape)} are "
                         "not [B,H,Tq,d], [B,H,Tk,d] and [B,H,Tq,d]")
    if tuple(kv_mask.shape) != (b, tk):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} != {(b, tk)}")
    if q_mask is not None and (q_mask.shape[0] != b
                               or q_mask.shape[1] < tq):
        raise ValueError(f"q_mask {tuple(q_mask.shape)} does not cover "
                         f"{(b, tq)}")


# ---------------------------------------------------------------------------
# layout planning for the kernels' TMA loads
# ---------------------------------------------------------------------------

TMA_ALIGN = 16   # bytes: TMA's rule for base addresses and strides


def tma_ready(x) -> bool:
    """Can the kernels read this [B,H,T,d] view in place? TMA needs a
    16-byte-aligned base, a unit column stride, d a multiple of 16 bytes
    (8 bf16 or 4 fp32 elements) and every other stride (of a dim longer
    than 1) a positive multiple of 16 bytes."""
    per = TMA_ALIGN // x.element_size()
    shape, st = x.shape, x.stride()
    if st[-1] != 1 or shape[-1] % per or x.data_ptr() % TMA_ALIGN:
        return False
    return all(n == 1 or (s > 0 and s % per == 0)
               for n, s in zip(shape[:-1], st[:-1]))


class TmaPlan(NamedTuple):
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    out: torch.Tensor      # what the kernel writes: out itself, or a padded buffer
    copied: tuple          # names of the operands that were copied


def plan_tma(q, k, v, out) -> TmaPlan:
    """Layout preparation for the kernels (either dtype, in elements of
    its size): views they can read in place pass through; a view with an
    unaligned base or stride is copied contiguous; a head dim that is not
    a multiple of 16 bytes (8 bf16, 4 fp32 elements) pads q, k, v and
    the output buffer with zero columns (zeros add nothing to q.k, and
    the output's extra columns are dropped). The copy is a fresh
    allocation even where the view is contiguous already (a contiguous
    view can start at an unaligned offset). The main path (d_head 128,
    slices of a fused projection) copies nothing."""
    d = q.shape[-1]
    per = TMA_ALIGN // q.element_size()
    dp = -(-d // per) * per
    if dp != d:
        def padded(x):
            y = x.new_zeros(*x.shape[:-1], dp)
            y[..., :d] = x
            return y
        buf = out.new_empty(*out.shape[:-1], dp)
        return TmaPlan(padded(q), padded(k), padded(v), buf,
                       ("q", "k", "v", "out"))
    ops, copied = [], []
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not tma_ready(x):
            x = x.clone(memory_format=torch.contiguous_format)
            copied.append(name)
        ops.append(x)
    if not tma_ready(out):
        copied.append("out")
        return TmaPlan(*ops, out.new_empty(out.shape), tuple(copied))
    return TmaPlan(*ops, out, tuple(copied))


def _strides(x) -> tuple:
    """(batch, head, row) element strides of a [B,H,T,d] view; a dim of
    length 1 is never stepped, so it gets the view's span (positive, a
    multiple of 8, past every real stride)."""
    shape, st = x.shape, x.stride()
    if shape[0] > 1 and shape[1] > 1 and shape[2] > 1:
        return st[:3]
    span = 1 + sum((n - 1) * s for n, s in zip(shape, st))
    span = -(-span // 8) * 8
    return tuple(s if n > 1 else span for n, s in zip(shape[:3], st[:3]))


def _attend(q, k, v, kv_mask, q_mask, out) -> None:
    """One launch of the kernel for q's dtype, writing out. q/k/v/out are
    [B,H,T,d] views (the unsplit layout is a view too: head stride d_k,
    row stride D or 2D)."""
    check_operands(q, k, v, out, kv_mask, q_mask)
    fn = getattr(_library(), kernel_symbol(q.dtype))
    b, h, tq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q, k, v, target, _ = plan_tma(q, k, v, out)
    kv_mask = _f32_on(kv_mask, q.device)
    if q_mask is not None:
        q_mask = _f32_on(q_mask if q_mask.shape[1] == tq else q_mask[:, :tq],
                         q.device)
    st = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k), *_strides(v),
                                  *_strides(target))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            None if q_mask is None else q_mask.data_ptr(), target.data_ptr(),
            b, h, tq, k.shape[2], q.shape[-1], st, scale)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:   # the kernel launches on the current device
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    if target is not out:
        out.copy_(target[..., :d])


def _unit_cols(x):
    return x if x.stride(-1) == 1 else x.contiguous()


def _f32_on(mask, device):
    """mask as a contiguous float32 tensor on device (no op when it is)."""
    if (mask.dtype == torch.float32 and mask.device == device
            and mask.is_contiguous()):
        return mask
    return mask.to(device=device, dtype=torch.float32).contiguous()


def _head_view(x, heads: int, d: int, col: int = 0):
    """Columns col..col+d of x [B,T,>=col+d] (unit column stride) as a
    [B,H,T,d/H] view, heads being column blocks: no split, no copy. One
    as_strided, where a slice, an unflatten and a transpose would take
    several times its host time on every launch."""
    dk = d // heads
    return x.as_strided((x.shape[0], heads, x.shape[1], dk),
                        (x.stride(0), dk, x.stride(1), 1),
                        x.storage_offset() + col)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def _split_heads(x, heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def attention_plain(q, k, v, kv_mask, q_mask=None, att_mask=None,
                    return_weights=False, operand_round=None,
                    score_dtype=torch.float32):
    """q [B,H,Tq,d], k/v [B,H,Tk,d], kv_mask [B,Tk] (>0 valid): fp32
    scores, -1e30 where masked, fp32 softmax cast to the input dtype,
    context; rows whose q_mask is 0 are zeroed when q_mask is given.
    att_mask ([B,Tq,Tk] or [Tq,Tk]) is the layers' extra mask, which only
    this plain branch takes. With return_weights, (context, the fp32
    softmax weights [B,H,Tq,Tk]). operand_round, where given, is applied
    to q, k, v and the softmax weights before the two products (the TF32
    control of the fp32 checks rounds them once to TF32). score_dtype
    bfloat16 (the layers' ASR2PASS_BF16_SCORES on bf16 inputs) keeps the
    scores in bf16 with a -30000 fill, as the JAX package's
    layers.py:256-265 does."""
    d = q.shape[-1]
    if operand_round is not None:
        q, k, v = (operand_round(x.float()).to(x.dtype) for x in (q, k, v))
    if score_dtype == torch.bfloat16:
        s = torch.einsum("bhtd,bhsd->bhts", q.to(score_dtype),
                         k.to(score_dtype)) / math.sqrt(d)
        neg = torch.tensor(-30000.0, dtype=s.dtype, device=s.device)
    else:
        s = torch.einsum("bhtd,bhsd->bhts", q.float(),
                         k.float()) / math.sqrt(d)
        neg = torch.tensor(_NEG, dtype=s.dtype, device=s.device)
    s = torch.where(kv_mask[:, None, None, :] > 0, s, neg)
    if att_mask is not None:
        am = att_mask if att_mask.dim() == 3 else att_mask[None]
        s = torch.where(am[:, None, :, :] > 0, s, neg)
    p = torch.softmax(s.float(), dim=-1)
    pv = p if operand_round is None else operand_round(p)
    out = torch.einsum("bhts,bhsd->bhtd", pv.to(q.dtype), v)
    if q_mask is not None:
        out = out * (q_mask[:, None, :q.shape[2], None] > 0).to(out.dtype)
    return (out, p) if return_weights else out


def mh_attention_plain(q, kv, kv_mask, heads: int, operand_round=None):
    """Plain version of mh_flash_attention: split heads from the column
    layout, attend, merge."""
    d = q.shape[-1]
    ctx = attention_plain(_split_heads(q, heads),
                          _split_heads(kv[..., :d], heads),
                          _split_heads(kv[..., d:], heads), kv_mask,
                          operand_round=operand_round)
    return _merge_heads(ctx)


# fp32 tolerance (atol, rtol) of the kernel against the plain version:
# |kernel - plain| <= 1e-4 + 1e-4 |plain|, fp32 arithmetic summed in
# another order over up to 5120 keys, the kernel's products in 3xTF32
# (about 22 significant bits). A single TF32 product per operand pair
# does not hold it (tests/test_torch_attention.py, chip_smoke.py).
FP32_TOL = (1e-4, 1e-4)

# bf16 limit of the kernel against the plain version evaluated in fp32:
#   |kernel - plain32| <= 2^-8 |plain32| + 2^-6 sqrt(sum_j p_j^2 v_j^2) + 1e-6
# The first term is the rounding of the bf16 output: bf16 keeps 8
# significant bits, so rounding moves a value by up to 2^-8 of itself.
# The second covers rounding P to bf16 before the P.V product, as the TPU
# kernels do (attention.py:67,96,184): each p_j picks up a relative error
# of up to 2^-8, roughly independent across j, so the output's error has
# a standard deviation of at most about 2^-8/sqrt(3) times
# sqrt(sum_j p_j^2 v_j^2); 2^-6 is about 7 of those. A correct kernel
# that stores bf16 can read close to the whole limit where |plain32| is
# large against the second term (the fp32 result rounded once reads up
# to about half of it on random data).
BF16_REL, BF16_P, BF16_ABS = 2.0 ** -8, 2.0 ** -6, 1e-6


def bf16_reference(q, k, v, kv_mask, q_mask=None):
    """The plain version evaluated in fp32 on q/k/v's values, and the
    bf16 limit of each output element (formula above). Split-head
    [B,H,T,d] layout, semantics of attention_plain."""
    vf = v.float()
    ref, p = attention_plain(q.float(), k.float(), vf, kv_mask, q_mask,
                             return_weights=True)
    spread = torch.einsum("bhts,bhsd->bhtd", p * p, vf * vf).sqrt()
    return ref, BF16_REL * ref.abs() + BF16_P * spread + BF16_ABS


def mh_bf16_reference(q, kv, kv_mask, heads: int):
    """bf16_reference for mh_flash_attention's unsplit layout; both in
    the merged [B,Tq,D] layout."""
    d = q.shape[-1]
    ref, limit = bf16_reference(_split_heads(q, heads),
                                _split_heads(kv[..., :d], heads),
                                _split_heads(kv[..., d:], heads), kv_mask)
    return _merge_heads(ref), _merge_heads(limit)


def tf32_split(x):
    """x (float32) as hi + lo, both TF32 values (float32 with the low 13
    mantissa bits zero): hi = x rounded to TF32, lo = x - hi rounded to
    TF32, each to nearest with ties away from zero, as cvt.rna.tf32.f32
    and the fp32 kernel's to_tf32 round (csrc/attention_f32_sm90.cu, the
    same integer form). Adding half of
    the dropped part's weight to the bit pattern rounds the magnitude, so
    signs, zeros, subnormals and the carry into the exponent come out
    right; values past the largest TF32 value round to +-inf. NaN stays
    NaN. For the tests and chip_smoke.py's controls; the main path does
    not call it."""
    def rna(y):
        bits = ((y.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isnan(y), y, bits)
    hi = rna(x)
    return hi, rna(x - hi)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _count(fn, dtype) -> None:
    """One launch of fn's kernel in dtype: the only place counts move."""
    key = _dtype_name(dtype)
    fn.launches_by_dtype[key] = fn.launches_by_dtype.get(key, 0) + 1


def refuse_autograd(name: str, *operands) -> None:
    """Raise where autograd would need a kernel's backward: gradients are
    on and an operand requires one. The kernels write a fresh tensor
    through ctypes and have no backward (nor have the JAX package's
    Pallas kernels, which have no custom_vjp), so their output would
    carry no gradient and a training step would drop attention's share of
    it without a word. Train below MIN_T, or call the plain version."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in operands):
        raise RuntimeError(
            f"{name}: the CUDA attention kernels have no backward, and an "
            "operand requires a gradient; run the step with segments "
            f"shorter than MIN_T={MIN_T} frames (the plain branch), or "
            "under torch.no_grad()")


def mh_flash_attention(q, kv, kv_mask, heads: int):
    """q [B,Tq,D]; kv [B,Tk,2D] (K then V columns); kv_mask [B,Tk] (>0
    valid). Returns context [B,Tq,D] in merged-head layout. Tq may differ
    from Tk (cross-attention). Views with unit column stride (e.g. the
    q/kv slices of a fused qkv projection) are read in place."""
    if not q.is_cuda:
        return mh_attention_plain(q, kv, kv_mask, heads)
    refuse_autograd("mh_flash_attention", q, kv)
    b, tq, d = q.shape
    if d % heads or kv.shape[0] != b or kv.shape[2] != 2 * d:
        raise ValueError(f"q {tuple(q.shape)} and kv {tuple(kv.shape)} "
                         f"are not [B,Tq,D] and [B,Tk,2D] with {heads} "
                         "heads")
    q, kv = _unit_cols(q), _unit_cols(kv)
    out = torch.empty((b, tq, d), dtype=q.dtype, device=q.device)
    if b == 0 or tq == 0:
        return out
    _attend(_head_view(q, heads, d), _head_view(kv, heads, d),
            _head_view(kv, heads, d, d), kv_mask, None,
            _head_view(out, heads, d))
    _count(mh_flash_attention, q.dtype)
    return out


def _split_launch(q, k, v, kv_mask, q_mask):
    """The kernel on split-head views: (output, whether it launched); an
    empty output launches nothing."""
    q, k, v = _unit_cols(q), _unit_cols(k), _unit_cols(v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return out, False
    _attend(q, k, v, kv_mask, q_mask, out)
    return out, True


def _attention_ss(q, k, v, kv_mask, q_mask=None):
    """Split-head attention, Tq != Tk allowed. kv_mask [B,Tk]; when q_mask
    [B,Tq] is given, rows whose q_mask is 0 come out as 0."""
    if not q.is_cuda:
        return attention_plain(q, k, v, kv_mask, q_mask)
    refuse_autograd("_attention_ss", q, k, v)
    out, launched = _split_launch(q, k, v, kv_mask, q_mask)
    if launched:
        _count(_attention_ss, q.dtype)
    return out


def _attention_flash(q, k, v, mask):
    """Split-head self-attention for T past MAX_T_SS_SPLIT; fully masked
    rows come out as 0."""
    if not q.is_cuda:
        return attention_plain(q, k, v, mask, mask)
    refuse_autograd("_attention_flash", q, k, v)
    out, launched = _split_launch(q, k, v, mask, mask)
    if launched:
        _count(_attention_flash, q.dtype)
    return out


def flash_attention(q, k, v, mask):
    """q,k,v [B,H,T,d]; mask [B,T] (>0 valid). Returns [B,H,T,d] with
    fully masked rows 0. T <= MAX_T_SS_SPLIT runs _attention_ss, longer T
    _attention_flash (the JAX package's split, attention.py:192-202)."""
    if q.shape[2] <= MAX_T_SS_SPLIT:
        return _attention_ss(q, k, v, mask, q_mask=mask)
    return _attention_flash(q, k, v, mask)


def cross_flash_attention(q, k, v, kv_mask):
    """q [B,H,Tq,d] against k/v [B,H,Tk,d] with kv_mask [B,Tk]; query rows
    are NOT zeroed (downstream token masks own that)."""
    return _attention_ss(q, k, v, kv_mask, q_mask=None)


KERNEL_ENTRY_POINTS = (mh_flash_attention, _attention_ss, _attention_flash)


def launch_counts() -> dict:
    """Launches of the CUDA kernels per entry point, both dtypes."""
    return {fn.__name__: sum(fn.launches_by_dtype.values())
            for fn in KERNEL_ENTRY_POINTS}


def launch_counts_by_dtype() -> dict:
    """Launches per entry point and input dtype: {name: {dtype: n}}."""
    return {fn.__name__: {_dtype_name(dt): fn.launches_by_dtype.get(
        _dtype_name(dt), 0) for dt in KERNELS} for fn in KERNEL_ENTRY_POINTS}


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches_by_dtype = {}


reset_launch_counts()


# ---------------------------------------------------------------------------
# dispatch gates (the JAX package's ops/attention.py:380-419), with the
# tensor's device in place of the JAX backend; below MIN_T the layers run
# their own plain branch, which is the JAX package's XLA branch, not a
# fallback
# ---------------------------------------------------------------------------

def use_flash(t: int, d_head: int, att_mask, is_cuda: bool) -> bool:
    """Unsplit-projection kernel (mh_flash_attention) for self-attention
    at MIN_T <= T <= MAX_T_SS with no extra attention mask."""
    return (is_cuda and att_mask is None and MIN_T <= t <= MAX_T_SS
            and d_head <= MAX_D_HEAD)


def use_flash_split(t: int, d_head: int, att_mask, is_cuda: bool) -> bool:
    """Split-head path (flash_attention) for self-attention past
    MAX_T_SS."""
    return (is_cuda and att_mask is None and t > MAX_T_SS
            and d_head <= MAX_D_HEAD)


def use_flash_cross(tq: int, tk: int, d_head: int, is_cuda: bool) -> bool:
    """Unsplit-projection kernel for cross-attention: MIN_T <= Tk <=
    MAX_T_SS and Tq >= MIN_T."""
    return (is_cuda and MIN_T <= tk <= MAX_T_SS and tq >= MIN_T
            and d_head <= MAX_D_HEAD)
