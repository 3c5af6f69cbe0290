"""Small shared utilities: device resolution, fp32 products and float
casts."""
from __future__ import annotations

from typing import Mapping, Union

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
    through. Counterpart of asr2pass_tpu/utils.py:8-16, used to run the
    serving path in bfloat16."""
    if isinstance(params, nn.Module):
        for p in params.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        return params
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in params.items()}
