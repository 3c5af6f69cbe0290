#!/usr/bin/env python3
"""Phase 10c of chip_smoke.py alone, again and again, to find how often it
dies: the websocket server with the batched engine, --lm-dir (a TLG graph)
and --itn-dir (FST grammars), 16 paced 2pass connections and a 60 s
upload. Each run is a process of its own, so that a crash ends that run
only; faulthandler prints every thread's Python stack when one dies.

  python3 chip_repro_10c.py [--runs 3] [--other DIR] [--log-dir DIR]

In this order: --runs runs of this checkout with the profiler window of
TRACE_TICKS engine ticks that chip_smoke opens, --runs without it (the
profiler replaced by a stub), and with --other (another checkout, for
example a parent commit unpacked with `git archive` into a git-ignored
directory) --runs of that checkout's chip_smoke.py and package with the
window. The model dirs are made once, on the card, from seed 0, by this
checkout's chip_smoke (its phase 3 and phase 7 dirs; the other weights
drawn in between in a whole run are not drawn here). Each run's output
goes to DIR/run_<k>.log; one JSON line per run (exit code, the signal
that ended it, seconds, the log's last line) and a summary line are
printed. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class _NoProfile:
    """Stands in for torch.profiler.profile: traces nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def key_averages(self):
        return []


def make_dirs(tmp: str) -> None:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.save_model_dir(os.path.join(tmp, "model"), gen)
    cs.save_2pass_dirs(tmp, gen)


def run_once(tmp: str, checkout: str, trace: bool) -> None:
    import faulthandler

    sys.path.insert(0, checkout)
    import chip_smoke as cs         # the checkout's own, with its package
    import torch

    if hasattr(cs, "install_crash_trace"):
        cs.install_crash_trace()    # before faulthandler, which chains to it
    faulthandler.enable()

    if not trace:
        import torch.profiler
        torch.profiler.profile = _NoProfile
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att

    print(f"repro: chip_smoke from {cs.__file__}, package from "
          f"{os.path.dirname(att.__file__)}, trace {trace}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    att.build()
    nb.build()
    card = cs.card_line()
    lm_setup = cs.lm_phase_dirs(os.path.join(tmp, f"lm10_{os.getpid()}"),
                                cs.cjk_tokens(cs.P10_VOCAB), card)
    cs.lm_server_phase(tmp, lm_setup, card)
    print("repro: 10c passed", flush=True)


def child(args: list, log: str, timeout: float) -> dict:
    t0 = time.perf_counter()
    with open(log, "w") as f:
        try:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__)]
                                + args, stdout=f, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = None
    with open(log, errors="replace") as f:
        lines = f.read().splitlines()
    return {"rc": rc,
            "signal": (signal.Signals(-rc).name if rc is not None and rc < 0
                       else None),
            "s": time.perf_counter() - t0,
            "last_line": lines[-1] if lines else ""}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--other", default="",
                   help="another checkout to run 10c from, with the window")
    p.add_argument("--log-dir", default="",
                   help="where each run's output goes (default: a new "
                        "temporary directory)")
    p.add_argument("--timeout", type=float, default=400.0,
                   help="seconds a run may take")
    p.add_argument("--make-dirs", default="", help=argparse.SUPPRESS)
    p.add_argument("--run", nargs=3, metavar=("TMP", "CHECKOUT", "TRACE"),
                   help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.make_dirs:
        make_dirs(a.make_dirs)
        return 0
    if a.run:
        run_once(a.run[0], a.run[1], a.run[2] == "1")
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_repro_10c: no CUDA device", file=sys.stderr)
        return 2
    log_dir = a.log_dir or tempfile.mkdtemp(prefix="repro10c_")
    os.makedirs(log_dir, exist_ok=True)
    plan = [("this", HERE, True)] * a.runs + [("this", HERE, False)] * a.runs
    if a.other:
        plan += [("other", os.path.abspath(a.other), True)] * a.runs
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        made = child(["--make-dirs", tmp], os.path.join(log_dir, "dirs.log"),
                     a.timeout)
        print(f"repro: model dirs {json.dumps(made)}", flush=True)
        if made["rc"] != 0:
            return 1
        for k, (which, checkout, trace) in enumerate(plan):
            res = {"run": k, "checkout": which, "trace": trace,
                   **child(["--run", tmp, checkout, "1" if trace else "0"],
                           os.path.join(log_dir, f"run_{k}.log"), a.timeout)}
            results.append(res)
            print(f"repro: {json.dumps(res)}", flush=True)
    summary = {}
    for r in results:
        key = f"{r['checkout']}_{'trace' if r['trace'] else 'no_trace'}"
        s = summary.setdefault(key, {"runs": 0, "passed": 0, "crashed": 0})
        s["runs"] += 1
        s["passed"] += r["rc"] == 0
        s["crashed"] += r["signal"] is not None
    print(json.dumps({"repro_10c": summary, "log_dir": log_dir}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
