"""The card: the peaks the per-layer readers divide by, and the check that
a measurement run has the cards its cell asks for.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
HBM3 3.35 TB/s; TF32 tensor cores 494.7 TFLOP/s, so float32 products at
float32 accuracy (3xTF32, three TF32 products a product) 494.7 / 3 =
164.9 TFLOP/s; bfloat16 989.4 TFLOP/s.
"""
from __future__ import annotations

import sys

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 494.7e12 / 3, "bfloat16": 989.4e12,
              "float16": 989.4e12}


def require_cards(chips: int) -> None:
    """Exit with code 2, printing no result, unless CUDA has `chips` cards."""
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; a measurement run needs the card",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {torch.cuda.device_count()} CUDA devices, the cell "
              f"needs {chips}", file=sys.stderr)
        raise SystemExit(2)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
