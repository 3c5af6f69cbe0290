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

On a CUDA tensor all three call one hand-written tensor-core kernel
(wgmma) per dtype: float32 the 3xTF32 kernel of
csrc/attention_f32_sm90.cu (a pre-pass that splits K and V once per
(batch, head) into tile images, the main kernel fed from them by bulk
copies, and, where f32_schedule splits the keys over blocks to fill the
card, a combine), bfloat16 the TMA-fed kernel of csrc/attention_sm90.cu.
Both read Q, K, V and write the output through (batch, head, row)
strides, so the unsplit layout needs no head split, merge or copy (a view
that the kernels' 16-byte rules cannot address is copied, see plan_tma).
A call looks up the plan of its layout (_Launch: the packed argument
block, made once with every check) and makes one ctypes call. What
bounds each kernel and how it is designed is described at the top of its
source. On a CPU tensor each entry point runs its plain version (einsum,
masked fp32 softmax, einsum: the XLA-path semantics of the JAX
package's models/layers.py:258-267); the fp32 kernel's steps have plain
versions too (f32_presplit_plain, f32_partials_plain, f32_combine_plain),
for the tests and the card's checks.
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
            # (plan block, q, k, v, kv_mask, q_mask, out, scratch, stream)
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9
            fn.restype = ctypes.c_int
            smem = getattr(lib, f"{name}_smem")
            smem.argtypes = [ctypes.c_int]
            smem.restype = ctypes.c_int
        steps = lib.asr2pass_attention_f32_steps
        steps.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
        steps.restype = ctypes.c_int
        lib.asr2pass_attention_f32_image.argtypes = [ctypes.c_int] * 2
        lib.asr2pass_attention_f32_image.restype = ctypes.c_int
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


class _Launch(NamedTuple):
    """What one shape, layout and dtype needs at every call, made once:
    the kernel's C entry, its packed argument block (csrc/tma.cuh
    PlanSlot), the output's shape and the scratch's size."""
    fn: object              # the ctypes entry of the dtype's kernel
    block: object           # the packed argument block (ctypes int64 array)
    args: int               # its address
    device: torch.device
    index: int              # CUDA device index
    out_shape: tuple
    scratch: int            # scratch bytes (0: none)
    v_offset: int           # bytes from k's pointer to v's (unsplit layout)
    schedule: object        # F32Schedule, or None (bf16)


# the slots of the packed argument block, in csrc/tma.cuh's PlanSlot order
PLAN_SLOTS = ("batch", "heads", "tq", "tk", "d", "d_scale", "device",
              "splits", "tiles",
              *(f"stride_{x}_{y}" for x in "qkvo" for y in "bht"),
              "off_tiles", "off_images", "off_part_o", "off_part_ml")
# plans by layout; a model's layers repeat a few shapes, so this stays
# small, and it is emptied if it ever grows past _PLANS_MAX
_PLANS: dict = {}
_PLANS_MAX = 4096
_SMS: dict = {}


def _sm_count(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _current_stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device `index` (no
    Stream object made)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _make_launch(q, k, v, out, d_scale: int, out_shape: tuple,
                 v_offset: int = 0) -> _Launch:
    """The launch of q's dtype's kernel on ready [B,H,T,d] views (plan_tma
    passes them), their strides and, in fp32, f32_schedule's schedule
    for this card's SM count."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    index = q.get_device()
    lib = _library()
    fn = getattr(lib, kernel_symbol(q.dtype))
    sched = (f32_schedule(b, h, tq, tk, d, _sm_count(index),
                          bk=lib.asr2pass_attention_f32_image(d, 2),
                          image=lib.asr2pass_attention_f32_image(d, 0))
             if q.dtype == torch.float32 else None)
    vals = {"batch": b, "heads": h, "tq": tq, "tk": tk, "d": d,
            "d_scale": d_scale, "device": index,
            "splits": sched.splits if sched else 1,
            "tiles": sched.tiles if sched else 0,
            "off_tiles": sched.off_tiles if sched else 0,
            "off_images": sched.off_images if sched else 0,
            "off_part_o": sched.off_part_o if sched else 0,
            "off_part_ml": sched.off_part_ml if sched else 0}
    for x, t in zip("qkvo", (q, k, v, out)):
        for y, st in zip("bht", _strides(t)):
            vals[f"stride_{x}_{y}"] = st
    block = (ctypes.c_longlong * len(PLAN_SLOTS))(
        *[vals[name] for name in PLAN_SLOTS])
    return _Launch(fn, block, ctypes.addressof(block), q.device, index,
                   tuple(out_shape), sched.scratch_bytes if sched else 0,
                   v_offset, sched)


def _remember(key, plan):
    if len(_PLANS) >= _PLANS_MAX:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


def _run(plan: _Launch, qp: int, kp: int, vp: int, kv_mask, q_mask,
         out) -> None:
    """One ctypes call: the kernel's launches on the current stream of
    the operands' device, with a fresh scratch buffer (stream-ordered, as
    every temporary of the caching allocator)."""
    scratch = (torch.empty(plan.scratch, dtype=torch.uint8,
                           device=plan.device) if plan.scratch else None)
    err = plan.fn(plan.args, qp, kp, vp, kv_mask.data_ptr(),
                  None if q_mask is None else q_mask.data_ptr(),
                  out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  _current_stream(plan.index))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")


def _attend(q, k, v, kv_mask, q_mask, out) -> None:
    """One call of the kernel for q's dtype, writing out. q/k/v/out are
    [B,H,T,d] views (the unsplit layout is a view too: head stride d_k,
    row stride D or 2D). Checks them, copies what TMA's rules do not
    take (plan_tma), and launches through the plan of the ready layout."""
    check_operands(q, k, v, out, kv_mask, q_mask)
    d = q.shape[-1]
    tq = q.shape[2]
    q, k, v, target, _ = plan_tma(q, k, v, out)
    kv_mask = _f32_on(kv_mask, q.device)
    if q_mask is not None:
        q_mask = _f32_on(q_mask if q_mask.shape[1] == tq else q_mask[:, :tq],
                         q.device)
    key = ("views", q.dtype, d, q.shape, k.shape, q.stride(), k.stride(),
           v.stride(), target.stride(), q.get_device())
    plan = _PLANS.get(key) or _remember(
        key, _make_launch(q, k, v, target, d, target.shape))
    _run(plan, q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask, q_mask,
         target)
    if target is not out:
        out.copy_(target[..., :d])


def f32_run_steps(q, k, v, kv_mask, q_mask, steps: int):
    """The fp32 kernel's launches named by `steps` (1 the pre-pass, 2 the
    main kernel, 4 the combine) on ready split-head views: (out, the
    scratch's parts as f32_scratch_views gives them). For the card's
    tests, which hold each step's scratch against its plain version."""
    if q.dtype != torch.float32 or not q.is_cuda:
        raise TypeError("f32_run_steps takes float32 CUDA tensors")
    check_operands(q, k, v, q, kv_mask, q_mask)
    out = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    plan = _make_launch(q, k, v, out, q.shape[-1], q.shape)
    sched = plan.schedule
    scratch = torch.zeros(sched.scratch_bytes, dtype=torch.uint8,
                          device=q.device)
    err = _library().asr2pass_attention_f32_steps(
        plan.args, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr(), None if q_mask is None else q_mask.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), _current_stream(plan.index),
        steps)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    return out, f32_scratch_views(sched, *q.shape[:3], q.shape[-1], scratch)


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
# the fp32 kernel's schedule and the plain versions of its device steps
# (csrc/attention_f32_sm90.cu: pre-pass, main kernel, combine). The
# schedule is a pure function of the shape; the plain versions are for
# the tests and chip_smoke.py, which hold each step's output on the card
# against them. The main path never calls them.
# ---------------------------------------------------------------------------

F32_MAX_SPLITS = 16      # (kMaxSplits)
F32_SMS = 132            # SMs of an H100 SXM; a launch passes its card's count
# the split planner's costs, in keys of one block's loop: a block's fixed
# work (its Q rows, the rings' first loads) and the combine's launch
F32_BLOCK_COST = 32
F32_COMBINE_COST = 64
_SCRATCH_ALIGN = 256


def f32_instance(d: int) -> int:
    """The head-dim instantiation (32, 64, 128 or 256 columns) that runs
    a head dim d <= 256."""
    return next(n for n in (32, 64, 128, 256) if d <= n)


def f32_bk(d: int) -> int:
    """Keys of one tile at head dim d (Cfg<D>::BK): 64, or 32 at the
    256-column instantiation, whose tile images fill shared memory."""
    return 64 if f32_instance(d) <= 128 else 32


def f32_image_bytes(d: int) -> int:
    """Bytes of one key tile's image in the scratch at head dim d: K hi,
    K lo (BK x the instantiation's width each, fp32), the BK key states,
    V^T hi, V^T lo."""
    return 4 * f32_bk(d) * f32_instance(d) * 4 + f32_bk(d) * 4


def f32_splits(blocks: int, tiles: int, sms: int = F32_SMS,
               bk: int = 64) -> int:
    """Key splits for `blocks` main-kernel blocks (one an SM) whose rows
    attend to `tiles` key tiles of bk keys: the S in 1..min(16, tiles)
    that minimises waves x (keys a split + a block's fixed cost), plus
    the combine's cost where S > 1; the smallest S on a tie."""
    best, best_cost = 1, None
    for s in range(1, min(F32_MAX_SPLITS, max(tiles, 1)) + 1):
        waves = -(-blocks * s // sms)
        cost = (waves * (-(-tiles // s) * bk + F32_BLOCK_COST)
                + (F32_COMBINE_COST if s > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


class F32Schedule(NamedTuple):
    d_inst: int            # head-dim instantiation
    rows: int              # query rows of a main-kernel block
    bk: int                # keys of a tile
    qblocks: int           # ceil(Tq / rows)
    tiles: int             # key tiles of Tk, ceil(Tk / bk)
    splits: int            # key splits (1: no partials, no combine)
    grid_presplit: tuple   # () where Tk = 0
    grid_main: tuple
    grid_combine: tuple    # () where splits == 1
    image_bytes: int       # one tile's image
    off_tiles: int         # byte offsets into the scratch: int32 [B]
    off_images: int        # [B, H, tiles] images
    off_part_o: int        # float32 [S, B, H, Tq, d]
    off_part_ml: int       # float32 [S, B, H, Tq, 2] (m, l)
    scratch_bytes: int


def _aligned(n: int) -> int:
    return -(-n // _SCRATCH_ALIGN) * _SCRATCH_ALIGN


def f32_schedule(b: int, h: int, tq: int, tk: int, d: int,
                 sms: int = F32_SMS, bk: int = None,
                 image: int = None) -> F32Schedule:
    """The fp32 kernel's grids, key splits and scratch layout for q
    [b,h,tq,d] against tk keys (d: the head dim the kernel reads, a
    multiple of 4), as csrc/attention_f32_sm90.cu's launch takes them.
    bk and image (a tile's keys and bytes) default to f32_bk and
    f32_image_bytes; a launch passes the built kernel's own."""
    n = f32_instance(d)
    rows = 128 if n <= 128 else 64
    bk = bk or f32_bk(d)
    image = image or f32_image_bytes(d)
    qblocks = -(-tq // rows)
    tiles = -(-tk // bk)
    splits = f32_splits(qblocks * h * b, tiles, sms, bk) if tk > 0 else 1
    off_images = _aligned(4 * b)
    off_part_o = off_images + _aligned(b * h * tiles * image)
    part = splits > 1
    off_part_ml = off_part_o + (_aligned(splits * b * h * tq * d * 4)
                                if part else 0)
    scratch = off_part_ml + (_aligned(splits * b * h * tq * 8) if part
                             else 0)
    return F32Schedule(
        n, rows, bk, qblocks, tiles, splits,
        (tiles, h, b) if tk > 0 else (), (qblocks * splits, h, b),
        (-(-tq * (d // 4) // 256), h, b) if part else (),
        image, 0, off_images, off_part_o, off_part_ml, scratch)


def f32_scratch_views(sched: F32Schedule, b: int, h: int, tq: int, d: int,
                      scratch) -> dict:
    """The parts of a scratch buffer (uint8) as tensors: tiles int32
    [B], images float32 [B, H, tiles, image_bytes / 4], part_o
    [S, B, H, Tq, d] and part_ml [S, B, H, Tq, 2] (splits > 1)."""
    def part(off, nbytes, dtype, shape):
        return scratch[off:off + nbytes].view(dtype).view(shape)
    s = sched.splits
    views = {"tiles": part(sched.off_tiles, 4 * b, torch.int32, (b,)),
             "images": part(sched.off_images,
                            b * h * sched.tiles * sched.image_bytes,
                            torch.float32, (b, h, sched.tiles,
                                            sched.image_bytes // 4))}
    if s > 1:
        views["part_o"] = part(sched.off_part_o, s * b * h * tq * d * 4,
                               torch.float32, (s, b, h, tq, d))
        views["part_ml"] = part(sched.off_part_ml, s * b * h * tq * 8,
                                torch.float32, (s, b, h, tq, 2))
    return views


def f32_tiles_plain(kv_mask, bk: int):
    """Plain version of the pre-pass's tile count: the tiles of bk keys a
    batch row is read over, up to its last valid key, or all ceil(Tk/bk)
    for a row with no valid key. int32 [B]."""
    b, tk = kv_mask.shape
    idx = torch.arange(tk, device=kv_mask.device)
    last = torch.where(kv_mask > 0, idx, -1).amax(dim=1) if tk else \
        torch.full((b,), -1, device=kv_mask.device)
    return torch.where(last >= 0, last // bk + 1,
                       -(-tk // bk)).to(torch.int32)


# V^T holds the keys of each 8-group in the order 0,2,4,6,1,3,5,7: the key
# at position p of a tile
F32_VT_KEYS = tuple(8 * (p // 8) + (2 * (p % 8) if p % 8 < 4
                                    else 2 * (p % 8 - 4) + 1)
                    for p in range(64))


def _swizzled(rows: int, cols: int):
    """Element index of (row, col) in a tile of 128-byte-swizzled
    32-column fp32 panels of `rows` rows: the kernel's swz / 4."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    cc = c % 32
    return ((c // 32) * rows * 32 + r * 32 + ((cc // 4) ^ (r % 8)) * 4
            + cc % 4)


def f32_presplit_plain(k, v, kv_mask):
    """Plain version of the pre-pass: every tile's image, float32
    [B, H, tiles, image_bytes / 4] (the kernel writes the tiles below
    f32_tiles_plain of each batch row). k, v [B,H,Tk,d] float32; K hi and
    lo in the swizzled K-major panels of the S product, the key states
    (1 valid, 0 masked, -1 past Tk), then V^T hi and lo ([d, keys] in
    panels of 32 keys, the keys in F32_VT_KEYS order); hi and lo from
    tf32_split, zero past Tk and past d."""
    b, h, tk, d = k.shape
    n, bk = f32_instance(d), f32_bk(d)
    tiles = -(-tk // bk)
    plane = bk * n

    def tiled(x):
        y = x.new_zeros(b, h, tiles * bk, n)
        y[:, :, :tk, :d] = x
        return y.view(b, h, tiles, bk, n)
    img = k.new_zeros(b, h, tiles, 4 * plane + bk)
    idx_k = _swizzled(bk, n).flatten().to(k.device)
    idx_v = _swizzled(n, bk).flatten().to(k.device)
    vt = tiled(v)[:, :, :, list(F32_VT_KEYS[:bk]), :].transpose(-1, -2)
    for at, x, idx in ((0, tiled(k), idx_k), (2 * plane + bk, vt, idx_v)):
        hi, lo = tf32_split(x.reshape(b, h, tiles, plane))
        img[..., at + idx] = hi
        img[..., at + plane + idx] = lo
    state = torch.full((b, tiles * bk), -1.0, device=k.device)
    state[:, :tk] = (kv_mask > 0).float()
    img[..., 2 * plane:2 * plane + bk] = state.view(b, 1, tiles, bk)
    return img


def f32_partials_plain(q, k, v, kv_mask, splits: int, bk: int):
    """Plain version of the main kernel's split partials: for each split
    s of a batch row's tiles of bk keys (f32_tiles_plain, ceil(n/S) tiles
    a split), over the keys of its tiles, m = max(-1e30, max_j s_j) with
    s_j = q.k_j / sqrt(d) * log2(e) (-1e30 masked, keys past Tk left
    out), l = sum_j 2^(s_j - m) and O = sum_j 2^(s_j - m) v_j. Returns
    (m [S,B,H,Tq], l [S,B,H,Tq], O [S,B,H,Tq,d]); a split that holds no
    tile has m = -inf, l = 0, O = 0 (the kernel writes nothing for it,
    and the combine skips it)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) \
        * (math.log2(math.e) / math.sqrt(d))
    s = torch.where(kv_mask[:, None, None, :] > 0, s,
                    torch.tensor(_NEG, device=s.device))
    n_tiles = f32_tiles_plain(kv_mask, bk).tolist()
    m = torch.full((splits, b, h, tq), -math.inf, device=q.device)
    l = torch.zeros((splits, b, h, tq), device=q.device)
    o = torch.zeros((splits, b, h, tq, d), device=q.device)
    for bi in range(b):
        per = -(-n_tiles[bi] // splits)
        for si in range(splits):
            lo_key = si * per * bk
            hi_key = min(tk, min(n_tiles[bi], (si + 1) * per) * bk)
            if hi_key <= lo_key:
                continue
            part = s[bi, :, :, lo_key:hi_key]
            mi = part.amax(dim=-1).clamp(min=_NEG)
            p = torch.exp2(part - mi[..., None])
            m[si, bi], l[si, bi] = mi, p.sum(dim=-1)
            o[si, bi] = torch.einsum("hts,hsd->htd", p,
                                     v[bi, :, lo_key:hi_key].float())
    return m, l, o


def f32_combine_plain(m, l, o, q_mask=None):
    """Plain version of the combine: M = max_s m_s, out = sum_s
    2^(m_s - M) O_s / max(sum_s 2^(m_s - M) l_s, 1e-30); rows whose
    q_mask is 0 are exact zeros. m, l [S,B,H,Tq]; O [S,B,H,Tq,d]."""
    mm = m.amax(dim=0)
    w = torch.exp2(m - mm)
    out = (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0).clamp(
        min=1e-30)[..., None]
    if q_mask is not None:
        keep = q_mask[:, None, :out.shape[2], None] > 0
        out = torch.where(keep, out, torch.zeros((), device=out.device))
    return out


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


# a plan that says: this layout needs _attend's checks and copies each call
_VIA_ATTEND = "via _attend"


def _mh_plan(q, kv, kv_mask, heads: int):
    """The launch of mh_flash_attention for this layout, made once: the
    checks of check_operands on the head views, and whether the kernel
    reads q, kv and the mask in place. Raises on what it does not take."""
    b, tq, d = q.shape
    if d % heads or kv.shape[0] != b or kv.shape[2] != 2 * d:
        raise ValueError(f"q {tuple(q.shape)} and kv {tuple(kv.shape)} "
                         f"are not [B,Tq,D] and [B,Tk,2D] with {heads} "
                         "heads")
    if b == 0 or tq == 0:
        return (b, tq, d)
    if q.stride(-1) != 1 or kv.stride(-1) != 1:
        return _VIA_ATTEND
    out = torch.empty((b, tq, d), dtype=q.dtype, device=q.device)
    qh, kh, vh, oh = (_head_view(q, heads, d), _head_view(kv, heads, d),
                      _head_view(kv, heads, d, d), _head_view(out, heads, d))
    check_operands(qh, kh, vh, oh, kv_mask, None)
    if not (all(map(tma_ready, (qh, kh, vh, oh)))
            and kv_mask.dtype == torch.float32 and kv_mask.is_contiguous()
            and kv_mask.device == q.device):
        return _VIA_ATTEND
    return _make_launch(qh, kh, vh, oh, d // heads, (b, tq, d),
                        vh.data_ptr() - kh.data_ptr())


def mh_flash_attention(q, kv, kv_mask, heads: int):
    """q [B,Tq,D]; kv [B,Tk,2D] (K then V columns); kv_mask [B,Tk] (>0
    valid). Returns context [B,Tq,D] in merged-head layout. Tq may differ
    from Tk (cross-attention). Views with unit column stride (e.g. the
    q/kv slices of a fused qkv projection) are read in place.

    On the card a call looks up the plan of its layout (shape, strides,
    dtype, device, 16-byte alignment of each pointer, the mask's layout)
    and makes one ctypes call; the checks ran when the plan was made."""
    if not q.is_cuda:
        return mh_attention_plain(q, kv, kv_mask, heads)
    if torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad):
        refuse_autograd("mh_flash_attention", q, kv)
    qp, kp = q.data_ptr(), kv.data_ptr()
    key = ("mh", heads, q.dtype, kv.dtype, q.shape, kv.shape, q.stride(),
           kv.stride(), q.get_device(), kv.get_device(), qp % TMA_ALIGN,
           kp % TMA_ALIGN, kv_mask.dtype, kv_mask.shape, kv_mask.stride(),
           kv_mask.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        plan = _remember(key, _mh_plan(q, kv, kv_mask, heads))
    if type(plan) is tuple:     # no rows: nothing to launch
        return torch.empty(plan, dtype=q.dtype, device=q.device)
    if plan is _VIA_ATTEND:
        q, kv = _unit_cols(q), _unit_cols(kv)
        b, tq, d = q.shape
        out = torch.empty((b, tq, d), dtype=q.dtype, device=q.device)
        _attend(_head_view(q, heads, d), _head_view(kv, heads, d),
                _head_view(kv, heads, d, d), kv_mask, None,
                _head_view(out, heads, d))
    else:
        out = torch.empty(plan.out_shape, dtype=q.dtype, device=plan.device)
        _run(plan, qp, kp, kp + plan.v_offset, kv_mask, None, out)
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
