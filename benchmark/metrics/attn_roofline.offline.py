"""attn_roofline.offline: the sum of the attention calls' bounds
(benchmark/lib/attn.py) over the device time of the kernels launched
inside the benchmark's range around each call (benchmark/lib/trace.py),
in %. Nothing when the trace holds no such kernel."""


def read(run):
    if run.trace is None or not run.trace["attn_device_s"]:
        return None
    return 100.0 * run.attn_bound_s / run.trace["attn_device_s"]
