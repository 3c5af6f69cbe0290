"""tick_ms_p95.2pass: the 95th percentile, in ms, of the server's engine
tick (one StreamEngine.step: the tick stage), over the samples the
program recorded inside the window."""
from benchmark.lib import serving


def read(run):
    stages = getattr(run.served, "stages", None) or {}
    v = serving.percentile(stages.get("tick", []), 95)
    return None if v is None else 1000.0 * v
