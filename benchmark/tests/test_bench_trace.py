"""The trace reduction on made-up profiler events: the busy union, the
kernels launched inside attention ranges, the idle gaps by host activity."""
from benchmark.lib import trace


class Ev:
    def __init__(self, name, s, e, dev=False, corr=0, linked=0):
        self._n, self._s, self._d = name, s, e - s
        self._dev, self._c, self._l = dev, corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def activity_type(self):
        if self._dev:
            return ("gpu_user_annotation" if self._n.startswith("bench.")
                    else "kernel")
        return "cpu_op"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_reduce():
    us = 1000
    events = [
        Ev("bench.asr", 0, 1000 * us),
        Ev("bench.attn", 100 * us, 200 * us),
        Ev("cudaLaunchKernel", 110 * us, 115 * us, corr=7),
        Ev("cudaLaunchKernel", 300 * us, 305 * us, corr=8),
        Ev("aten::item", 400 * us, 900 * us),
        Ev("attention_kernel_f32_sm90", 120 * us, 180 * us, dev=True,
           corr=7),
        Ev("gemm", 160 * us, 350 * us, dev=True, corr=8),
        Ev("Memcpy DtoH", 950 * us, 960 * us, dev=True),
        # the host ranges as the profiler also draws them on the device
        Ev("bench.asr", 0, 1000 * us, dev=True),
        Ev("bench.attn", 120 * us, 180 * us, dev=True, corr=7),
    ]
    s = trace.reduce_events(events, 0, 1000 * us)
    assert s["kernels"] == 2
    assert abs(s["busy_s"] - (230 + 10) * 1e-6) < 1e-12
    assert abs(s["attn_device_s"] - 60e-6) < 1e-12
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert abs(gaps["bench.asr / aten::item"] - 600e-6) < 1e-12
    assert s["device_ops"][0][0] == "gemm"
