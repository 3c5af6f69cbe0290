"""The traced window: torch.profiler over host and device, reduced to what
the per-layer readers take.

From the profiler's raw events (kineto results, read once):
- every device activity's [start, end) on the host clock, their union
  inside the window (`busy_s`), its complement (idle) and the gaps;
- kernel launches (device activities that are kernels, not copies);
- the device time of the kernels launched inside the benchmark's own
  annotated ranges ("bench.attn"), found through the launch call's
  correlation id, so a range owns whatever kernels its call launched;
- each idle gap named by the innermost benchmark range and the innermost
  host operation running at its middle;
- the device operations that took most time.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional

ATTN = "bench.attn"
# gaps shorter than this are launch spacing; they count in the idle share
# but are not named one by one
NAMED_GAP_NS = 20_000


def _dev_kind(ev) -> str:
    """'kernel', 'copy', 'range' (a host range drawn on the device's
    timeline, which is no work of the device) or '' (a host event)."""
    if "CUDA" not in str(ev.device_type()):
        return ""
    name = ev.name()
    kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
    if "annotation" in kind or name.startswith("bench."):
        return "range"
    if "memcpy" in kind or "memset" in kind or name.startswith(
            ("Memcpy", "Memset", "memcpy", "memset")):
        return "copy"
    return "kernel"


def _union(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Window:
    """One traced stretch of the run. Use: start(), the work, stop()."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.summary: Optional[dict] = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self):
        import torch

        torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self.prof.stop()
        self.summary = reduce_events(
            self.prof.profiler.kineto_results.events(), self.t0_ns,
            self.t1_ns)
        self.prof = None
        return self.summary


def reduce_events(events, t0_ns: int, t1_ns: int) -> dict:
    """The summary of one window from raw profiler events (see the module
    docstring)."""
    dev: List[tuple] = []
    kernels = 0
    by_name: Dict[str, int] = defaultdict(int)
    launch_at: Dict[int, int] = {}
    op_at: Dict[int, int] = {}
    host: List[tuple] = []
    ranges: List[tuple] = []
    dev_corr: List[tuple] = []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        kind = _dev_kind(ev)
        if kind == "range":
            continue
        if kind:
            s, e = max(s, t0_ns), min(e, t1_ns)
            if e <= s:
                continue
            dev.append((s, e))
            by_name[ev.name()] += e - s
            if kind == "kernel":
                kernels += 1
                dev_corr.append((ev.correlation_id(),
                                 ev.linked_correlation_id(), e - s))
            continue
        name = ev.name()
        if "Launch" in name or name.startswith(("cuda", "cu")):
            launch_at[ev.correlation_id()] = s
        else:
            op_at[ev.correlation_id()] = s
        if name == ATTN:
            ranges.append((s, e))
        host.append((s, e, name))
    merged = _union(dev)
    busy = sum(e - s for s, e in merged)
    window = t1_ns - t0_ns
    # the kernels whose launch lies inside an attention range
    ranges.sort()
    starts = [r[0] for r in ranges]
    attn_ns = 0
    attn_kernels = 0
    for corr, linked, dur in dev_corr:
        at = launch_at.get(corr)
        if at is None:
            at = op_at.get(linked)
        if at is None or not ranges:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and ranges[i][0] <= at <= ranges[i][1]:
            attn_ns += dur
            attn_kernels += 1
    gaps = _gaps(merged, t0_ns, t1_ns)
    return {
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "kernels": kernels,
        "attn_device_s": attn_ns / 1e9,
        "attn_ranges": len(ranges),
        "attn_kernels": attn_kernels,
        "device_ops": sorted(((n, t / 1e9) for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": _name_gaps(gaps, host)[:10],
    }


def _gaps(merged: List[list], t0: int, t1: int) -> List[tuple]:
    out, at = [], t0
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def _name_gaps(gaps: List[tuple], host: List[tuple]) -> List[list]:
    """Idle time by what the host was doing: the innermost benchmark range
    and the innermost host operation at each gap's middle."""
    host.sort()
    starts = [h[0] for h in host]
    bench = [h for h in host
             if h[2].startswith("bench.") and h[2] != ATTN]
    total: Dict[str, int] = defaultdict(int)
    short = 0
    for s, e in gaps:
        if e - s < NAMED_GAP_NS:
            short += e - s
            continue
        mid = (s + e) // 2
        inner = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][0] <= mid < host[j][1]:
                inner = host[j][2]
                break
        where = [b for b in bench if b[0] <= mid < b[1]]
        label = (f"{where[-1][2] if where else 'outside'} / "
                 f"{inner or 'no host op'}")
        total[label] += e - s
    out = [[k, v / 1e9] for k, v in total.items()]
    if short:
        out.append([f"gaps under {NAMED_GAP_NS // 1000} us", short / 1e9])
    return sorted(out, key=lambda x: -x[1])
