"""p2_recognize_ms_p95.2pass: the 95th percentile, in ms, of one pass-2
batch's recognize_batch on the engine's pass-2 lane (the p2_recognize
stage), over the samples the program recorded inside the window."""
from benchmark.lib import serving


def read(run):
    stages = getattr(run.served, "stages", None) or {}
    v = serving.percentile(stages.get("p2_recognize", []), 95)
    return None if v is None else 1000.0 * v
