"""The program's own span records of the traced window.

A completed file's transcribe result carries the request record of the
program's runtime/metrics (`OfflineResult.trace`: per span name its
count, total and self nanoseconds; the counters). This sums the records
of the window's completed files, the files `audio_s_per_s` counts. A
program without the records gives None, and so does every reader.
"""
from __future__ import annotations

from typing import Optional


def totals(run) -> Optional[dict]:
    """{"spans": {name: {"n", "total_ns", "self_ns"}}, "counts": {name:
    int}} summed over the window's completed files, or None when no file
    carries a record."""
    served = run.served
    if served is None or served.audio_s <= 0:
        return None
    recs = [getattr(r.result, "trace", None) for r in served.done]
    recs = [r for r in recs if r]
    if not recs:
        return None
    spans: dict = {}
    counts: dict = {}
    for rec in recs:
        for name, s in rec["spans"].items():
            t = spans.setdefault(name, {"n": 0, "total_ns": 0, "self_ns": 0})
            for k in t:
                t[k] += s[k]
        for name, n in rec["counts"].items():
            counts[name] = counts.get(name, 0) + n
    return {"spans": spans, "counts": counts}


def ms_per_audio_s(run, name: str) -> Optional[float]:
    """The span's total host milliseconds over the window's audio
    seconds."""
    t = totals(run)
    if t is None or name not in t["spans"]:
        return None
    return t["spans"][name]["total_ns"] / 1e6 / run.served.audio_s


def fetches(t: dict) -> list:
    """The fetch spans' entries: each holds one blocking copy to the
    host."""
    return [s for name, s in t["spans"].items() if name.endswith(".fetch")]
