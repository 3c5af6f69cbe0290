"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is in
files of its own, found by name:
- benchmark/workloads/<cell>.json: the cell's configuration, traffic kind
  and traffic parameters;
- benchmark/configs/<config>.json: the sizes and the limits of the check,
  with its family (benchmark/families/<family>.py: the program's entry,
  its hooks and the comparison with benchmark/reference/);
- benchmark/traffic/<kind>.py: the generator of the mix and the loop
  that serves it;
- benchmark/metrics/<metric>.py: read(run) -> value or None, one file a
  metric of BENCHMARK.json.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED = ("jax", "jaxlib", "flax", "asr2pass_tpu")
# a traced run traces this much of its window: the per-layer metrics are
# ratios, and a longer trace only costs reading time
TRACE_SECONDS = 10.0


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its files read."""

    def __init__(self, name: str, manifest: Optional[dict] = None,
                 workload: Optional[dict] = None,
                 config: Optional[dict] = None):
        self.manifest = manifest or load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in entries:
            raise SystemExit(f"benchmark: no workload {name!r}")
        self.entry = entries[name]
        self.name = name
        self.workload = workload or load_json(
            BENCH / "workloads" / f"{name}.json")
        self.config = config or load_json(
            BENCH / "configs" / f"{self.entry['config']}.json")

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in this kind of run."""
        out = []
        for m in self.manifest["per_layer" if trace else "end_to_end"]:
            if self.name in m.get("workloads", [self.name]):
                out.append(m)
        return out


def reader(name: str):
    """benchmark/metrics/<name>.py (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What the readers read."""

    def __init__(self):
        self.setup_s = 0.0
        self.served = None      # the traffic's record of the window
        self.trace = None       # trace.reduce_events' summary
        self.attn_bound_s = None
        self.flops = 0.0
        self.peak_flops = 0.0


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def host_usage() -> tuple:
    """This process's user and system CPU seconds and its involuntary
    context switches so far."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, r.ru_nivcsw


def usage_line(before: tuple, after: tuple, wall_s: float) -> str:
    cpu, nivcsw = (y - x for x, y in zip(before, after))
    return (f"host CPU {cpu:.2f} s of {wall_s:.2f} s, {nivcsw} "
            "involuntary switches")


def run(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """The whole run; returns the result line's object.

    The family (benchmark/families/<family>.py) builds the program's entry
    and judges what it served; the traffic kind (benchmark/traffic/<kind>.py)
    makes the load from the seed and drives the entry: Load(family, entry,
    params, seed, device) with warm(), drive(seconds, traced) -> a window
    record (attempted, failed, errors, completed, window_s), summary(),
    sample() and flops(). The metric readers read that record."""
    import torch

    from benchmark.families import common
    from benchmark.lib import attn, chip
    from benchmark.lib import trace as trace_mod

    family = importlib.import_module(
        f"benchmark.families.{cell.config['family']}").Family(cell.config)
    kind = importlib.import_module(
        f"benchmark.traffic.{cell.workload['traffic']}")
    t0 = time.perf_counter()
    entry = family.build(seed, device)
    t1 = time.perf_counter()
    load = kind.Load(family, entry, cell.workload["params"], seed, device)
    t2 = time.perf_counter()
    load.warm()
    t3 = time.perf_counter()
    print(f"benchmark: set-up: {process_age_s() - (t3 - t0):.2f} s to the "
          f"models, models {t1 - t0:.2f} s (weights "
          f"{family.weights_s:.2f} s), traffic {t2 - t1:.2f} s, "
          f"warm-up {t3 - t2:.2f} s", file=sys.stderr)
    window = None
    if trace:
        window = trace_mod.Window(device)
        window.start()       # the profiler's own start-up, outside the window
        torch.ones(1, device=device).add_(1)
        window.stop()
        seconds = min(seconds, TRACE_SECONDS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = Run()
    rec.setup_s = process_age_s()   # process start to the first request
    common.STAGE_S.clear()
    u0 = host_usage()
    if trace:
        with attn.recording() as calls:
            served = load.drive(seconds, traced=window)
    else:
        served = load.drive(seconds)
    u1 = host_usage()
    rec.served = served
    print(f"benchmark: window {served.window_s:.2f} s, "
          f"{load.summary(served)}; {usage_line(u0, u1, served.window_s)}; "
          "host s in " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(common.STAGE_S.items())),
          file=sys.stderr)
    device_out = chip.device_info(device, cell.entry["chips"])
    bad = banned_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    if trace:
        rec.trace = window.summary
        print("benchmark: trace " + json.dumps(
            {k: rec.trace[k] for k in ("window_s", "busy_s", "kernels",
                                       "attn_ranges", "attn_kernels",
                                       "attn_device_s")}), file=sys.stderr)
        rec.attn_bound_s = calls.bound_s()
        rec.flops = load.flops(served)
        rec.peak_flops = chip.PEAK_FLOPS[cell.config["dtype"]]
        device_out["busy_s"] = rec.trace["busy_s"]
        device_out["window_s"] = rec.trace["window_s"]
    sample = load.sample(served, seed)
    # the check, after the program is gone
    family.free()
    del entry, load
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    read = common.Readings()
    t4 = time.perf_counter()
    family.check(sample, seed, device, read)
    print(f"benchmark: the check took {time.perf_counter() - t4:.2f} s over "
          f"{len(sample)} requests", file=sys.stderr)
    checks = compare(read.values, cell.config["limits"])
    for err in served.errors[:3]:
        print(f"benchmark: a request failed: {err}", file=sys.stderr)
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (served.failed == 0 and served.completed > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": served.attempted,
           "failed": served.failed, "metrics": metrics, "device": device_out}
    if trace:
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    for name, value in sorted(read.values.items()):
        if name not in checks:
            print(f"benchmark: reading {name} {value!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["checks"] = checks
    return out


def compare(values: dict, limits: dict) -> dict:
    """Each limited number beside its limit; one never read is 0 (nothing
    off); a number that is not finite fails."""
    out = {}
    for name, limit in limits.items():
        v = float(values.get(name, 0.0))
        out[name] = {"value": v if math.isfinite(v) else 1e300,
                     "limit": limit}
    return out
