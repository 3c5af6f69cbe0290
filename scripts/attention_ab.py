#!/usr/bin/env python3
"""Time variants of the port's attention kernels against each other on
one NVIDIA card, at the main-path shapes of chip_smoke.py's kernel phase.

    python3 scripts/attention_ab.py [--dtype float32] CSRC_DIR [CSRC_DIR ...]

Each CSRC_DIR is a copy of asr2pass_tpu_torch/csrc (edited to make a
variant; "checkout" means the checkout's own). Each runs in its own
process, which builds that directory's library into <CSRC_DIR>/../_build
and prints one line: device ms per call (best of three device_time_ms
runs of 20 calls) and the share of FP32_TOL against the plain version, at
#1 self, #1 cross, #2 and #3. Compare variants only within one call,
in turns (A B B A). Run from the root of a checkout.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("mh_flash_attention", (16, 1024, 1024, 512, 4)),
          ("mh_flash_attention", (16, 520, 1024, 512, 4)),
          ("_attention_ss", (2, 4, 3072, 128)),
          ("_attention_flash", (2, 4, 5120, 128))]


def run_variant(csrc: str, dtype: str) -> str:
    from pathlib import Path

    import torch

    import chip_smoke as cs
    from asr2pass_tpu_torch.ops import attention as att

    if csrc != "checkout":
        att.CSRC = Path(csrc).resolve()
        att.BUILD_DIR = att.CSRC.parent / "_build"
    att.build()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, shape in SHAPES:
        if name == "mh_flash_attention":
            b, tq, tk, d, h = shape
            q = torch.randn(b, tq, d, generator=gen, device="cuda", dtype=dt)
            kv = torch.randn(b, tk, 2 * d, generator=gen, device="cuda",
                             dtype=dt)
            mask = cs._mask(cs._lengths(b, tk, gen), tk)
            run = lambda: att.mh_flash_attention(q, kv, mask, h)
            ref = att.mh_attention_plain(q.float(), kv.float(), mask, h)
        else:
            b, h, t, d = shape
            qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda",
                              dtype=dt)
            qh, kh, vh = (a.unflatten(-1, (h, d)).transpose(1, 2)
                          for a in qkv.split(h * d, dim=-1))
            mask = cs._mask(cs._lengths(b, t, gen), t)
            fn = getattr(att, name)
            run = lambda: (fn(qh, kh, vh, mask, mask)
                           if name == "_attention_ss"
                           else fn(qh, kh, vh, mask))
            ref = att.attention_plain(qh.float(), kh.float(), vh.float(),
                                      mask, mask)
        got = run()
        torch.cuda.synchronize()
        atol, rtol = att.FP32_TOL
        share = ((got.float() - ref).abs() / (atol + rtol * ref.abs())
                 ).max().item()
        dev = min(cs.device_time_ms(run, 20)[0] for _ in range(3))
        out.append(f"{name}{list(shape)} device_ms {dev:.4f} "
                   f"share_of_fp32_tol {share:.3f}")
    return f"{csrc} {dtype}: " + " | ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.one:
        print(run_variant(args.variants[0], args.dtype), flush=True)
        return 0
    rc = 0
    for v in args.variants:
        rc |= subprocess.run([sys.executable, __file__, "--one", "--dtype",
                              args.dtype, v], cwd=REPO).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
