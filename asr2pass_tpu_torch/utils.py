"""Small shared utilities: device resolution, batched host-device
copies, fp32 products, float casts and int8 weight quantization."""
from __future__ import annotations

from typing import List, Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. A CUDA device on a machine without one raises: nothing
    quietly runs on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def to_device(device: torch.device, rows: np.ndarray) -> torch.Tensor:
    """A small host int array [k, n] (per-slot counters, offsets) as int64
    on `device` in one copy: pinned and asynchronous on the card, so the
    upload waits for nothing queued before it. Rows unpack as tensors."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Several device tensors in ONE device-to-host copy (one
    synchronisation): each is flattened to int32 (floats as float32 bit
    patterns, integers and bools converted), all are concatenated,
    copied, and split again on the host. Returns numpy arrays of the
    tensors' shapes: float32 for floats, bool for bool, int32 otherwise
    (token ids and counts, far below 2^31)."""
    if not tensors:
        return []
    parts = []
    for x in tensors:
        if x.is_floating_point():
            parts.append(x.float().reshape(-1).view(torch.int32))
        else:
            parts.append(x.reshape(-1).to(torch.int32))
    flat = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for x in tensors:
        a = flat[at: at + x.numel()]
        at += x.numel()
        if x.is_floating_point():
            a = a.view(np.float32)
        elif x.dtype == torch.bool:
            a = a.astype(bool)
        out.append(a.reshape(tuple(x.shape)))
    return out


def fp32_products() -> None:
    """fp32 products stay true fp32 on the card: no TF32 in cuBLAS or
    cuDNN. The fbank (frontend/fbank.py) feeds a log, and the models'
    fp32 path is held to the CPU's. Every entry point that builds a model
    calls it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_floats(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                dtype: torch.dtype):
    """Cast the floating-point parameters of a module (in place, returned)
    or of a state dict (a new dict) to `dtype`; other entries pass
    through. Counterpart of the JAX package's utils.py:8-16, used to run the
    serving path in bfloat16."""
    if isinstance(params, nn.Module):
        for p in params.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return params
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in params.items()}


# subtrees whose weights stay float: convs and embeddings (the JAX
# package's utils.py:43-44), and the bicif upsampling conv `us_cnn`, which
# its list means by `us_conv` and misses (its quantized tree then fails
# in the timestamp head)
QUANT_SKIP = ("conv", "us_conv", "us_cnn", "embed")


def div_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, rounded once on every device. PyTorch's CUDA division by a
    Python number multiplies by the number's reciprocal, which can land one
    ulp away from the quotient that the CPU and the JAX package compute; a
    divisor that is a tensor on t's device takes the true division."""
    return t / t.new_full((), 127.0)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel int8: w [.., d_in, d_out] -> (w_q int8 of w's
    shape, scale [.., d_out] in w's dtype), scale = max|w| over d_in / 127
    floored at 1e-12, w_q = clip(round(w / scale), -127, 127) with ties
    to even (jnp.round's rule)."""
    scale = div_127(w.abs().amax(dim=-2, keepdim=True)).clamp_min(1e-12)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(-2)


def quantize_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                    weight_only: bool = False):
    """Int8 weights for every dense layer outside QUANT_SKIP. Counterpart
    of the JAX package's utils.py:27-62 on a module (converted in place,
    returned) or a state dict (a new dict). A dense node's `w` becomes
    `w_q` (w8a8: models/layers.dense quantizes each activation row and
    takes an int8 product) or, with weight_only, `w_q8` (w8a16: the
    product runs in the activations' dtype), plus `scale`; `b` stays.
    Cast to bf16 first for the bf16 serving route, as the JAX package's
    bench does, so that `scale` is bf16. A tensor-parallel shard
    (parallel/sharding.shard_params) is refused: quantize, then shard."""
    key = "w_q8" if weight_only else "w_q"
    if isinstance(params, nn.Module):
        for name, mod in params.named_modules():
            if getattr(mod, "tp_group", None) is not None:
                raise ValueError(
                    f"{name} is a tensor-parallel shard: quantize the whole "
                    "model, then shard it (the JAX package's scales on a "
                    "row-parallel shard are a max over the whole input "
                    "axis, not over this rank's rows)")
        for name, mod in params.named_modules():
            if (hasattr(mod, "quantize_") and mod.weight_key == "w"
                    and not set(name.split(".")) & set(QUANT_SKIP)):
                mod.quantize_(weight_only)
        return params
    out = dict(params)
    for k in list(out):
        node, _, leaf = k.rpartition(".")
        if (leaf != "w" or out[k].dim() not in (2, 3)
                or f"{node}.taps" in out
                or set(node.split(".")) & set(QUANT_SKIP)):
            continue
        w_q, scale = quantize_weight(out.pop(k))
        out[f"{node}.{key}"] = w_q
        out[f"{node}.scale"] = scale
    return out
