"""Serving metrics: per-stage latency, audio accounting and a profiler
hook.

Counterpart of the JAX package's runtime/metrics.py (StageStats, Metrics,
GLOBAL, device_trace). The engine's tick_* and vd_* stages, the server's
2pass_feed / offline_decode stages and its `stats` action read them.
device_trace wraps torch.profiler instead of jax.profiler.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    samples: List[float] = field(default_factory=list)
    _cap: int = 1000

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        if len(self.samples) < self._cap:
            self.samples.append(dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(p / 100 * len(s)))]


class Metrics:
    """Process-wide stage timers + audio accounting. The tick and the
    engine's lanes record from their own threads, so updates take a
    lock."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.audio_seconds = 0.0
        self.started = time.time()
        self._lock = threading.Lock()

    def reset(self):
        """Drop every stage's samples (a new measurement window)."""
        with self._lock:
            self.stages.clear()

    def add_stage(self, name: str, dt: float):
        with self._lock:
            self.stages[name].add(dt)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(name, time.perf_counter() - t0)

    def add_audio(self, seconds: float):
        with self._lock:
            self.audio_seconds += seconds

    def report(self) -> dict:
        wall = time.time() - self.started
        out = {
            "uptime_s": round(wall, 1),
            "audio_seconds": round(self.audio_seconds, 1),
            "throughput_audio_s_per_s": round(
                self.audio_seconds / wall, 2) if wall else 0.0,
            "stages": {},
        }
        with self._lock:
            stages = list(self.stages.items())
        for name, st in stages:
            out["stages"][name] = {
                "count": st.count,
                "mean_ms": round(st.mean_s * 1000, 2),
                "p50_ms": round(st.percentile(50) * 1000, 2),
                "p95_ms": round(st.percentile(95) * 1000, 2),
                "max_ms": round(st.max_s * 1000, 2),
            }
        return out


GLOBAL = Metrics()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    where there is one), written for TensorBoard to `logdir`. CUPTI stays
    set up after the block (TEARDOWN_CUPTI=0, unless the caller set it):
    Kineto's teardown finalizes CUPTI inside the next kernel launch, and
    a launch from another thread (a live engine's lanes) can then crash
    the process."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
