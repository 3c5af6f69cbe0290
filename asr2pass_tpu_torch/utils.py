"""Small shared utilities: device resolution, batched host-device
copies, fp32 products and float casts."""
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
