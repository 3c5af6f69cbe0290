"""Serving metrics: the port's spans, request records and counters.

Counterpart of the JAX package's runtime/metrics.py (StageStats, Metrics,
GLOBAL). `Metrics.stage(name)` is the one span primitive. On exit it
1. adds the duration to the process-wide StageStats of `name` (the
   engine's tick_* and vd_* stages, the server's 2pass_feed /
   offline_decode stages, the offline path's spans; the server's `stats`
   action reads them);
2. adds it to the request record bound to the current context, if any
   (Metrics.request: per span name its count, total and self time, self
   being the duration less that of the span's direct children);
3. is also a profiler range, while a profiler is active only, so a trace
   shows the program's spans on the clock of the device's kernels. The
   range is a host range of function scope (the profiler's fast record
   function): a user-scope `record_function` range is drawn on the
   device's timeline too, as a `gpu_user_annotation` over the kernels it
   launched, which a reader of the device's intervals takes for device
   work.
The open spans and the bound record live in context variables, so the
engine's lanes and the server's threads keep theirs apart.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as host_range

# the newest samples a stage keeps for its percentiles
_SAMPLES = 1000


@dataclass(slots=True)
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    samples: Deque[float] = field(
        default_factory=lambda: deque(maxlen=_SAMPLES))

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt
        self.samples.append(dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(p / 100 * len(s)))]


class _Span:
    """One span; while open, the innermost of its context, with its parent
    and the time its closed children took."""
    __slots__ = ("metrics", "name", "parent", "child_ns", "t0", "token",
                 "range")

    def __init__(self, metrics: "Metrics", name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = host_range(self.name)
            self.range.__enter__()
        self.parent = _OPEN.get()
        self.child_ns = 0
        self.token = _OPEN.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _OPEN.reset(self.token)
        if self.parent is not None:
            self.parent.child_ns += dt
        rec = _RECORD.get()
        if rec is not None:
            s = rec["spans"].get(self.name)
            if s is None:
                s = rec["spans"][self.name] = {"n": 0, "total_ns": 0,
                                               "self_ns": 0}
            s["n"] += 1
            s["total_ns"] += dt
            s["self_ns"] += dt - self.child_ns
        self.metrics.add_stage(self.name, dt * 1e-9)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()

# the innermost open span and the bound request record of this context
_OPEN: contextvars.ContextVar[Optional[_Span]] = contextvars.ContextVar(
    "asr2pass_open_span", default=None)
_RECORD: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "asr2pass_request_record", default=None)


class Metrics:
    """Process-wide stage timers, counters and audio accounting. The tick
    and the engine's lanes record from their own threads, so updates take
    a lock."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.counts: Dict[str, int] = defaultdict(int)
        self.audio_seconds = 0.0
        self.born = self.started = time.time()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def reset(self):
        """A new measurement window: every stage's samples, the counters
        and the audio seconds dropped, the window's clock restarted."""
        with self._lock:
            self.stages.clear()
            self.counts.clear()
            self.audio_seconds = 0.0
            self.started = time.time()

    def add_stage(self, name: str, dt: float):
        with self._lock:
            self.stages[name].add(dt)

    def stage(self, name: Optional[str]):
        """A span: `with metrics.stage(name): ...` (see the module's
        docstring); name None: no span."""
        return _NO_SPAN if name is None else _Span(self, name)

    @contextlib.contextmanager
    def request(self):
        """Binds a fresh request record to the current context for the
        block and yields it: {"id", "start_ns", "end_ns", "spans": {name:
        {"n", "total_ns", "self_ns"}}, "counts": {name: int}}. The start
        and end are time.time_ns(), the profiler's clock."""
        rec = {"id": next(self._ids), "start_ns": time.time_ns(),
               "end_ns": 0, "spans": {}, "counts": {}}
        token = _RECORD.set(rec)
        try:
            yield rec
        finally:
            _RECORD.reset(token)
            rec["end_ns"] = time.time_ns()

    def count(self, name: str, n: int = 1):
        """Adds n to the counter `name`: the bound record's and the
        process-wide total."""
        rec = _RECORD.get()
        if rec is not None:
            rec["counts"][name] = rec["counts"].get(name, 0) + n
        with self._lock:
            self.counts[name] += n

    def add_audio(self, seconds: float):
        with self._lock:
            self.audio_seconds += seconds

    def report(self) -> dict:
        now = time.time()
        window = now - self.started
        out = {
            "uptime_s": round(now - self.born, 1),
            "window_s": round(window, 1),
            "audio_seconds": round(self.audio_seconds, 1),
            "throughput_audio_s_per_s": round(
                self.audio_seconds / window, 2) if window else 0.0,
            "stages": {},
        }
        with self._lock:
            for name, st in self.stages.items():
                out["stages"][name] = {
                    "count": st.count,
                    "mean_ms": round(st.mean_s * 1000, 2),
                    "p50_ms": round(st.percentile(50) * 1000, 2),
                    "p95_ms": round(st.percentile(95) * 1000, 2),
                    "max_ms": round(st.max_s * 1000, 2),
                }
            out["counts"] = dict(self.counts)
        return out


GLOBAL = Metrics()
