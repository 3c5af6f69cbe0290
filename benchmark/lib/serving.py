"""Arithmetic of the serving cells: the FLOPs of one streaming pass-1
step of one stream, and the percentiles the latency readers take.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from benchmark.lib import flops


def online_step_flops(cfg, n: int, u: int) -> float:
    """One stream's pass-1 step that takes n new LFR frames and fires u
    tokens: the SAN-M encoder and the alphas over the step's window of
    lookback + lookahead + n frames, and the decoder's u tokens against
    that window (2 x multiply-adds of the products, as flops.paraformer
    counts them, which is this sum at t = the window)."""
    lookback, _center, lookahead = cfg.chunk_size
    return flops.paraformer(cfg, lookback + lookahead + n, u)


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The nearest-rank p-th percentile (None for no values): the
    smallest value that at least p % of the values do not exceed."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(p / 100 * len(s)) - 1)]
