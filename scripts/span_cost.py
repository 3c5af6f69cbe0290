"""What one span of runtime/metrics costs the host with no profiler active:
nanoseconds per `with METRICS.stage(name)`, alone and inside a bound
request record, beside a perf_counter_ns pair, the profiler flag check
and the two kinds of profiler range entered without a profiler. Each is
the best of five timed loops; one JSON line.

    python scripts/span_cost.py [--n 200000]
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402

from asr2pass_tpu_torch.runtime.metrics import Metrics, host_range  # noqa


def per_call_ns(fn, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    n = p.parse_args(argv).n
    m = Metrics()

    def loop(_n):
        for _ in range(_n):
            pass

    def clock_pair(_n):
        for _ in range(_n):
            t0 = time.perf_counter_ns()
            time.perf_counter_ns() - t0

    def flag(_n):
        for _ in range(_n):
            autograd_profiler._is_profiler_enabled

    def span(_n):
        for _ in range(_n):
            with m.stage("cost.span"):
                pass

    def recorded(_n):
        with m.request():
            for _ in range(_n):
                with m.stage("cost.span"):
                    pass

    def ungated(_n):
        for _ in range(_n):
            with record_function("cost.span"):
                pass

    def ungated_host(_n):
        for _ in range(_n):
            with host_range("cost.span"):
                pass

    base = per_call_ns(loop, n)
    out = {name: round(per_call_ns(fn, n) - base, 1) for name, fn in (
        ("clock_pair_ns", clock_pair), ("flag_check_ns", flag),
        ("span_ns", span), ("span_in_record_ns", recorded),
        ("record_function_ns", ungated), ("host_range_ns", ungated_host))}
    out["host"] = platform.processor() or platform.machine()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
