"""The port's profiler hook (runtime/metrics.device_trace) on the CPU: it
writes a trace and leaves CUPTI set up between traces (TEARDOWN_CUPTI=0)
unless the caller chose otherwise, since Kineto's teardown can crash a
process whose other threads launch kernels (chip_repro_profiler.py)."""
import os

import torch

from asr2pass_tpu_torch.runtime.metrics import device_trace


def test_device_trace_writes_a_trace_and_keeps_cupti(tmp_path, monkeypatch):
    # set first, so that the test's end restores what was there before
    monkeypatch.setenv("TEARDOWN_CUPTI", "")
    monkeypatch.delenv("TEARDOWN_CUPTI")
    with device_trace(str(tmp_path)):
        torch.ones(64, 64).sum()
    assert any(tmp_path.iterdir())
    assert os.environ["TEARDOWN_CUPTI"] == "0"


def test_device_trace_keeps_the_callers_setting(tmp_path, monkeypatch):
    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    with device_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.environ["TEARDOWN_CUPTI"] == "1"
