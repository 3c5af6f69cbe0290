"""p1_dispatch_ms_p95.2pass: the 95th percentile, in ms, of the tick's
pass-1 staging and the dispatch of its fused steps (the tick_p1_dispatch
stage), over the samples the program recorded inside the window."""
from benchmark.lib import serving


def read(run):
    stages = getattr(run.served, "stages", None) or {}
    v = serving.percentile(stages.get("tick_p1_dispatch", []), 95)
    return None if v is None else 1000.0 * v
