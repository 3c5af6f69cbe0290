#!/usr/bin/env python3
"""The smoke script's segmentation fault, alone: several threads launch
CUDA work the way the engine's lanes do (small kernels, pinned
host-to-device copies, device-to-host copies behind an event, two
streams, the fp32 attention kernel), while the main thread opens and
closes torch.profiler windows of CUDA activity. Kineto's CUPTI teardown
after a window (TEARDOWN_CUPTI=1, torch's default) crashes such a
process now and then; chip_smoke.py turns it off. Each scenario
is a process of its own, so that a crash ends that scenario only; the
crash prints every thread's Python stack and the faulting thread's
native frames (chip_smoke.install_crash_trace).

  python3 chip_repro_profiler.py [--scenarios threads:45,windows:110,...]
                                 [--log-dir DIR]

Scenarios (name:seconds):
  threads      the launching threads alone, no profiler
  before       one profiler window before the threads start, none after
  windows      windows of 0.02-0.3 s, one after another, while they run
  gated        the same, with the threads held off while a window opens
               and while it closes
  noteardown   `windows` with TEARDOWN_CUPTI=0 (Kineto keeps CUPTI set up
               between windows instead of finalizing it after each)
Prints the torch library's Kineto teardown strings, then one JSON line
per scenario (exit code, seconds, windows) and each failing log's end.
Needs one card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THREADS = 8
DEFAULT = "threads:45,before:45,windows:110,gated:110,noteardown:60"


class Gate:
    """Any number of threads inside at once; close() waits until none is
    and keeps new ones out until open()."""

    def __init__(self):
        self.cond = threading.Condition()
        self.inside = 0
        self.closed = False

    def enter(self):
        with self.cond:
            while self.closed:
                self.cond.wait()
            self.inside += 1

    def leave(self):
        with self.cond:
            self.inside -= 1
            self.cond.notify_all()

    def close(self):
        with self.cond:
            self.closed = True
            while self.inside:
                self.cond.wait()

    def open(self):
        with self.cond:
            self.closed = False
            self.cond.notify_all()


def launcher(stop: threading.Event, idx: int, gate) -> None:
    import torch

    from asr2pass_tpu_torch.ops import attention as att

    g = torch.Generator(device="cuda").manual_seed(idx)
    w = torch.randn(256, 256, device="cuda", generator=g) * 0.05
    host = torch.zeros(4, 256 * 64, dtype=torch.int16).pin_memory()
    stream = torch.cuda.Stream() if idx % 2 else torch.cuda.current_stream()
    mask = torch.ones(4, 256, device="cuda")
    n = 0
    with torch.no_grad(), torch.cuda.stream(stream):
        while not stop.is_set():
            if gate is not None:
                gate.enter()
            try:
                wav = host.to("cuda", non_blocking=True).float()
                x = wav[:, :256 * 64].reshape(4, 256, 64).repeat(1, 1, 4)
                for _ in range(6):
                    x = torch.tanh(x @ w)
                if idx == 0:
                    x = att.mh_flash_attention(x, torch.cat([x, x], -1),
                                               mask, 2)
                ev = torch.cuda.Event()
                ev.record()
                out = x.sum(-1).to("cpu", non_blocking=True)
                ev.synchronize()
                out.numpy().sum()
                n += 1
            finally:
                if gate is not None:
                    gate.leave()
    print(f"thread {idx}: {n} iterations", flush=True)


def scenario(name: str, seconds: float) -> None:
    import faulthandler

    sys.path.insert(0, HERE)
    import chip_smoke as cs      # sets TEARDOWN_CUPTI=0 unless it is set

    cs.install_crash_trace()
    faulthandler.enable()
    import torch
    from torch.profiler import ProfilerActivity, profile

    print(f"{name}: TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}",
          flush=True)
    if name == "before":
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.randn(100, 100, device="cuda").sum().item()
    gate = Gate() if name == "gated" else None
    stop = threading.Event()
    threads = [threading.Thread(target=launcher, args=(stop, i, gate))
               for i in range(THREADS)]
    for t in threads:
        t.start()
    rnd = random.Random(1)
    t0, windows, kept = time.time(), 0, []
    while time.time() - t0 < seconds:
        if name not in ("windows", "gated", "noteardown"):
            time.sleep(0.5)
            continue
        prof = profile(activities=[ProfilerActivity.CUDA])
        for step in (prof.start, prof.stop):
            if gate is not None:
                gate.close()
                torch.cuda.synchronize()
            step()
            if gate is not None:
                gate.open()
            if step == prof.start:
                time.sleep(rnd.uniform(0.02, 0.3))
        # the server phases read a window back after it has closed
        kept.append(prof)
        if len(kept) > 4:
            kept.pop(0).key_averages()
        time.sleep(rnd.uniform(0.0, 0.3))
        windows += 1
    stop.set()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    print(f"{name}: done, {windows} windows in {time.time() - t0:.1f} s",
          flush=True)


def teardown_strings() -> str:
    import torch

    found = []
    for lib in sorted(glob.glob(os.path.join(os.path.dirname(torch.__file__),
                                             "lib", "libtorch*.so"))):
        out = subprocess.run(["strings", lib], capture_output=True,
                             text=True).stdout
        hits = [s for s in out.splitlines()
                if "TEARDOWN_CUPTI" in s or "teardownCupti" in s]
        if hits:
            found.append(f"{os.path.basename(lib)}: {' | '.join(hits)}")
    return "; ".join(found) or "none"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_repro_profiler: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default=DEFAULT)
    ap.add_argument("--log-dir", default="",
                    help="each scenario's log (default: a new temporary "
                         "directory)")
    args = ap.parse_args()
    args.log_dir = args.log_dir or tempfile.mkdtemp(prefix="repro_prof_")
    os.makedirs(args.log_dir, exist_ok=True)
    sys.path.insert(0, HERE)
    from asr2pass_tpu_torch.ops import attention as att

    att.build()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; Kineto "
          f"teardown strings: {teardown_strings()}", flush=True)
    failed = 0
    for item in args.scenarios.split(","):
        name, seconds = item.split(":")
        env = dict(os.environ)
        env["TEARDOWN_CUPTI"] = "0" if name == "noteardown" else "1"
        log = os.path.join(args.log_dir, f"{name}.log")
        t0 = time.time()
        with open(log, "w") as f:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", name,
                 seconds], stdout=f, stderr=subprocess.STDOUT, env=env,
                timeout=float(seconds) + 180)
        text = open(log).read()
        done = [ln for ln in text.splitlines() if ": done," in ln]
        print(json.dumps({"scenario": name, "rc": res.returncode,
                          "s": round(time.time() - t0, 1),
                          "done": done[0] if done else None}), flush=True)
        if res.returncode != 0:
            failed += 1
            print(text[-8000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        scenario(sys.argv[2], float(sys.argv[3]))
        sys.exit(0)
    sys.exit(main())
