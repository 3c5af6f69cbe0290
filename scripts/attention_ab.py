#!/usr/bin/env python3
"""Time variants of the port's attention kernels against each other on
one NVIDIA card, at the shapes of chip_smoke.py's kernel phase, the
small-grid shapes of the serving paths included.

    python3 scripts/attention_ab.py [--sdpa] [--host] [--steps]
        [--shapes 0,4,5] VARIANT [VARIANT ...]

A VARIANT is "checkout" (this checkout), a copy of
asr2pass_tpu_torch/csrc (edited to make a kernel variant; it builds into
<dir>/../_build), or the root of another checkout (a directory holding
asr2pass_tpu_torch/, e.g. the parent commit unpacked with `git archive`):
its own wrapper and kernels run. Each runs in its own process and prints
one line a shape: ms per call back to back (CUDA events around 20
calls), device ms (best of three runs of 20 calls queued behind a spin
kernel), host ms (the host's clock around the enqueueing) and the share
of FP32_TOL against the plain version, all in float32; --sdpa adds
torch's scaled_dot_product_attention on the same inputs (a yardstick the
port never calls). --host adds a
time.perf_counter breakdown of the wrapper's host path at the serving
shapes (T <= 260): the inclusive microseconds a call spends in each of
the wrapper's functions that the variant has, torch.empty and the C
call (the timers' own cost, about 0.3 us each, is in the numbers).
--steps adds the device ms of each launch of the fp32 kernel (pre-pass,
main, combine; chip_smoke.f32_step_ms, a profiler trace); --shapes takes
only those entries of SHAPES.
Compare variants only within one call, in turns (A B B A). Run from the
root of a checkout.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (entry point, shape, meta rows): meta 4 draws SenseVoice's key lengths
SHAPES = [("mh_flash_attention", (16, 1024, 1024, 512, 4), 0),
          ("mh_flash_attention", (16, 520, 1024, 512, 4), 0),
          ("_attention_ss", (2, 4, 3072, 128), 0),
          ("_attention_flash", (2, 4, 5120, 128), 0),
          # the small grids: the 2pass session's pass 2 and the engine
          # lane at bucket 256, SenseVoice's 60 s and 150 s uploads
          ("mh_flash_attention", (1, 256, 256, 512, 4), 0),
          ("mh_flash_attention", (16, 256, 256, 512, 4), 0),
          ("mh_flash_attention", (16, 260, 260, 512, 4), 4),
          ("mh_flash_attention", (1, 1028, 1028, 512, 4), 4),
          ("_attention_ss", (1, 4, 3076, 128), 4),
          ("_attention_flash", (1, 4, 5124, 128), 4)]
HOST_SHAPES = [s for s in SHAPES if s[0] == "mh_flash_attention"
               and s[1][1] <= 260]
# the wrapper's functions a host breakdown times, where a variant has them
HOST_PIECES = ("refuse_autograd", "_unit_cols", "_head_view",
               "check_operands", "plan_tma", "_f32_on", "_strides",
               "_attend", "_mh_plan", "_run", "_current_stream", "_count")


def _inputs(att, cs, name, shape, meta, dt, gen):
    """(call, plain fp32 reference, sdpa call) at one shape."""
    import torch
    import torch.nn.functional as F

    if name == "mh_flash_attention":
        b, tq, tk, d, h = shape
        if tq == tk:
            qkv = torch.randn(b, tq, 3 * d, generator=gen, device="cuda",
                              dtype=dt)
            q, kv = qkv[..., :d], qkv[..., d:]
        else:
            q = torch.randn(b, tq, d, generator=gen, device="cuda", dtype=dt)
            kv = torch.randn(b, tk, 2 * d, generator=gen, device="cuda",
                             dtype=dt)
        mask = cs._mask(cs._lengths(b, tk, gen, meta), tk)
        run = lambda: att.mh_flash_attention(q, kv, mask, h)
        ref = lambda: att.mh_attention_plain(q.float(), kv.float(), mask, h)
        heads = [x.unflatten(-1, (h, d // h)).transpose(1, 2)
                 for x in (q, kv[..., :d], kv[..., d:])]
    else:
        b, h, t, d = shape
        qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda",
                          dtype=dt)
        heads = [a.unflatten(-1, (h, d)).transpose(1, 2)
                 for a in qkv.split(h * d, dim=-1)]
        qh, kh, vh = heads
        mask = cs._mask(cs._lengths(b, t, gen, meta), t)
        fn = getattr(att, name)
        run = lambda: (fn(qh, kh, vh, mask, mask)
                       if name == "_attention_ss" else fn(qh, kh, vh, mask))
        ref = lambda: att.attention_plain(qh.float(), kh.float(),
                                          vh.float(), mask, mask)
    sdpa_mask = (mask > 0)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(*heads,
                                                  attn_mask=sdpa_mask)
    return run, ref, sdpa


def host_breakdown(att, run, calls: int = 200) -> str:
    """Inclusive host microseconds a call in each wrapper function, in
    torch.empty and in the C call, over `calls` calls of run (the device
    held by a spin kernel meanwhile)."""
    import ctypes

    import torch

    spent = {}

    def timed(label, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[label] = spent.get(label, 0.0) + \
                    time.perf_counter() - t0
        return call

    class TorchProxy:
        empty = staticmethod(timed("torch.empty", torch.empty))

        def __getattr__(self, name):
            return getattr(torch, name)

    class LibProxy:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            return timed("C call", fn) if isinstance(
                fn, ctypes._CFuncPtr) else fn

    saved = {n: getattr(att, n) for n in HOST_PIECES if hasattr(att, n)}
    library = att._library
    lib = library()
    try:
        for n, fn in saved.items():
            setattr(att, n, timed(n, fn))
        att.torch = TorchProxy()
        att._library = lambda: LibProxy(lib)
        if hasattr(att, "_PLANS"):
            att._PLANS.clear()
        run()
        torch.cuda.synchronize()
        spent.clear()
        torch.cuda._sleep(int(2e9))
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        total = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(att, n, fn)
        att.torch = torch
        att._library = library
        if hasattr(att, "_PLANS"):
            att._PLANS.clear()
    parts = ", ".join(f"{k} {v * 1e6 / calls:.1f}"
                      for k, v in sorted(spent.items(), key=lambda x: -x[1]))
    return f"host us a call {total * 1e6 / calls:.1f} (timed): {parts}"


def run_variant(variant: str, sdpa: bool, host: bool, steps: bool,
                shapes: list) -> str:
    from pathlib import Path

    import torch

    root = Path(variant).resolve() if variant != "checkout" else None
    if root is not None and (root / "asr2pass_tpu_torch").is_dir():
        sys.path.insert(0, str(root))       # another checkout's wrapper
    sys.path.insert(1, REPO)
    import chip_smoke as cs
    from asr2pass_tpu_torch.ops import attention as att

    if root is not None and not (root / "asr2pass_tpu_torch").is_dir():
        att.CSRC = root
        att.BUILD_DIR = att.CSRC.parent / "_build"
    att.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for i, (name, shape, meta) in enumerate(SHAPES):
        if shapes and i not in shapes:
            continue
        run, ref_fn, sdpa_fn = _inputs(att, cs, name, shape, meta, dt, gen)
        got = run()
        ref = ref_fn()
        atol, rtol = att.FP32_TOL
        limit = atol + rtol * ref.abs()
        torch.cuda.synchronize()
        share = ((got.float() - ref).abs() / limit).max().item()
        line = f"{name}{list(shape)}"
        for label, call in (("", run),) + ((("sdpa ", sdpa_fn),) if sdpa
                                           else ()):
            b2b = cs.time_ms(call, 20)
            dev, host_ms = min(cs.device_time_ms(call, 20) for _ in range(3))
            line += (f" {label}ms b2b {b2b:.4f} device {dev:.4f} host "
                     f"{host_ms:.4f}")
        line += f" share {share:.3f}"
        if steps:
            split = cs.f32_step_ms(run)
            line += " | steps ms " + (", ".join(
                f"{k} {v:.4f}" for k, v in split.items()) if split
                else "not measured")
        if host and (name, shape, meta) in HOST_SHAPES:
            line += " | " + host_breakdown(att, run)
        out.append(line)
        del got, ref, limit
    return f"{variant} float32:\n  " + "\n  ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        shapes = [int(x) for x in args.shapes.split(",") if x]
        print(run_variant(args.variants[0], args.sdpa, args.host,
                          args.steps, shapes), flush=True)
        return 0
    rc = 0
    for v in args.variants:
        cmd = [sys.executable, __file__, "--one", v]
        cmd += ["--sdpa"] * args.sdpa + ["--host"] * args.host
        cmd += ["--steps"] * args.steps + ["--shapes", args.shapes]
        rc |= subprocess.run(cmd, cwd=REPO).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
