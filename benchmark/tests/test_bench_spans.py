"""The program's spans as the benchmark reads them: the trace reduction
with a program span among the events, the six readers of the span
records on a CPU rehearsal's served window, and, on the card, every
blocking copy to the host of one transcription inside a fetch span.

    python -m pytest benchmark/tests/test_bench_spans.py -q [-m cuda -s]
"""
import collections
import importlib
import math
import traceback
import warnings

import pytest
import torch
from torch.overrides import TorchFunctionMode

import bench_tiny
from benchmark.families import common
from benchmark.lib import harness, spans, trace
from benchmark.traffic import bulk_files

CELLS = bench_tiny.cells()
READERS = ["vad_ms_per_audio_s.offline", "asr_ms_per_audio_s.offline",
           "punc_ms_per_audio_s.offline", "fetch_wait_share.offline",
           "syncs_per_audio_s.offline", "pad_share.offline"]


class Ev:
    """A raw profiler event: a host event, or a device activity (a kernel,
    or a host range drawn on the device's timeline)."""

    def __init__(self, name, s, e, dev=False, corr=0):
        self._n, self._s, self._d = name, s, e - s
        self._dev, self._c = dev, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def activity_type(self):
        if not self._dev:
            return "user_annotation" if "." in self._n else "cpu_op"
        return "gpu_user_annotation" if "." in self._n else "kernel"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_program_span_names_a_gap_and_is_no_device_work():
    us = 1000
    events = [
        Ev("bench.vad", 0, 1000 * us),
        Ev("vad.net", 50 * us, 150 * us),
        Ev("cudaLaunchKernel", 60 * us, 65 * us, corr=3),
        Ev("fsmn_kernel", 70 * us, 120 * us, dev=True, corr=3),
        Ev("vad.automaton", 200 * us, 700 * us),
        # the program's spans as the profiler draws them on the device
        Ev("vad.net", 60 * us, 140 * us, dev=True),
        Ev("vad.automaton", 210 * us, 690 * us, dev=True),
    ]
    s = trace.reduce_events(events, 0, 1000 * us)
    assert s["kernels"] == 1
    assert abs(s["busy_s"] - 50e-6) < 1e-12
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # the gap over the automaton (120-1000 us, its middle at 560 us)
    assert abs(gaps["bench.vad / vad.automaton"] - 880e-6) < 1e-12
    assert [n for n, _ in s["device_ops"]] == ["fsmn_kernel"]


def _served(name, seed=2147483611):
    """A cell at its CPU rehearsal size, served for a 1 s window, as the
    readers get it; and the benchmark's own host seconds in its ranges."""
    cell = bench_tiny.cell(name)
    family = importlib.import_module(
        f"benchmark.families.{cell.config['family']}").Family(cell.config)
    cpu = torch.device("cpu")
    entry = family.build(seed, cpu)
    try:
        load = bulk_files.Load(family, entry, cell.workload["params"], seed,
                               cpu)
        load.warm()
        common.STAGE_S.clear()
        served = load.drive(1.0)
    finally:
        family.free()
    run = harness.Run()
    run.served = served
    return run, dict(common.STAGE_S)


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_a_rehearsal(name):
    run, stage_s = _served(name)
    values = {m: harness.reader(m).read(run) for m in READERS}
    punc = name.startswith("plarge")
    for m, v in values.items():
        if m.startswith("punc_") and not punc:
            assert v is None
        else:
            assert v is not None and math.isfinite(v) and v >= 0, (m, v)
    audio_s = run.served.audio_s
    # the program's spans hold the benchmark's ranges around the same calls
    for span, rng in (("vad", "bench.vad"), ("asr", "bench.asr")):
        got = values[f"{span}_ms_per_audio_s.offline"] * audio_s / 1e3
        assert stage_s[rng] <= got <= 1.05 * stage_s[rng] + 0.005, span
    # one fetch a front-end chunk and one a VAD net call (each 1 s window
    # of these files has both), one a file's recognize_batch, one a
    # punctuation window
    done = run.served.done
    windows = sum(-(-len(r.samples) // 16000) for r in done)
    reckoned = (2 * windows + len(done)
                + sum(1 for r in done for w in r.windows if w[0])) / audio_s
    assert values["syncs_per_audio_s.offline"] == pytest.approx(reckoned)
    assert 0 < values["fetch_wait_share.offline"] < 100
    assert 0 < values["pad_share.offline"] < 100


def test_a_program_without_records_reads_none():
    run = harness.Run()
    run.served = bulk_files.Window()
    run.served.audio_s = 10.0
    served = common.Served(torch.zeros(16000).numpy())
    served.result = type("Result", (), {})()
    run.served.done.append(served)
    assert spans.totals(run) is None
    assert all(harness.reader(m).read(run) is None for m in READERS)


# -- on the card ------------------------------------------------------------

def _host_data(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "cpu" and x.dim() > 0
    if isinstance(x, list):
        # a list of numbers (torch.tensor's data), or the call's arguments
        return any(_host_data(y) for y in x) or (
            len(x) > 0 and all(isinstance(y, (int, float)) for y in x))
    return type(x).__module__ == "numpy"


def _on_card(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(_on_card(y) for y in x)
    return False


class Uploads(TorchFunctionMode):
    """Marks the synchronising calls that copy host data to the card (a
    blocking copy from pageable memory synchronises the stream too):
    each outermost torch call that takes host data and touches the card,
    or makes a card tensor from no card tensor (torch.tensor(x,
    device=...))."""

    def __init__(self, syncs):
        super().__init__()
        self.syncs = syncs
        self.func = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = len(self.syncs)
        self.func = getattr(func, "__name__", str(func))
        try:
            out = func(*args, **kwargs)
        finally:
            self.func = None
        inputs = list(args) + list(kwargs.values())
        if len(self.syncs) > before and (
                _host_data(inputs) and (_on_card(out) or _on_card(inputs))
                or _on_card(out) and not _on_card(inputs)):
            for s in self.syncs[before:]:
                s["upload"] = True
        return out


def _caller() -> str:
    """The innermost frame of the program on the stack."""
    at = [f for f in traceback.extract_stack()
          if "asr2pass_tpu_torch" in f.filename]
    if not at:
        return "?"
    f = at[-1]
    return f"{f.filename.rsplit('asr2pass_tpu_torch/', 1)[-1]}:{f.lineno}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_every_blocking_copy_to_the_host_is_a_fetch_span(name):
    """Under the sync debug mode, one transcription at the rehearsal's
    widths: each synchronising call that is no upload happens inside a
    `*.fetch` span, one in each, so the record's fetch count is the
    count of blocking copies to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from asr2pass_tpu_torch.runtime import metrics

    cell = bench_tiny.cell(name)
    family = importlib.import_module(
        f"benchmark.families.{cell.config['family']}").Family(cell.config)
    dev = torch.device("cuda", 0)
    seed = 2147483613
    entry = family.build(seed, dev)
    try:
        wave = bulk_files.pool(cell.workload["params"], seed, dev)[1]
        entry(wave)                              # builds and caches
        torch.cuda.synchronize()
        syncs = []

        def hook(message, *rest):
            if "synchroniz" in str(message):
                syncs.append({"span": metrics._OPEN.get(), "upload": False,
                              "at": f"{_caller()} {uploads.func}"})

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                uploads = Uploads(syncs)
                with uploads:
                    res = entry(wave)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        family.free()
    fetch_n = sum(s["n"] for k, s in res.trace["spans"].items()
                  if k.endswith(".fetch"))
    copies = [s for s in syncs if not s["upload"]]
    outside = [s["at"] for s in copies if s["span"] is None
               or not s["span"].name.endswith(".fetch")]
    print(f"{name}: {len(syncs)} synchronising calls, "
          f"{len(syncs) - len(copies)} uploads, {len(copies)} copies to "
          f"the host, {fetch_n} fetch spans "
          f"({len(wave) / 16000:.0f} audio s); uploads at "
          + ", ".join(f"{k} x{v}" for k, v in sorted(collections.Counter(
              s["at"] for s in syncs if s["upload"]).items())))
    assert not outside, outside
    assert len(copies) == fetch_n
    assert len({id(s["span"]) for s in copies}) == fetch_n
