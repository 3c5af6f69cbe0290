"""Whole runs of each cell at a small size on the CPU, past the look for a
card: the result line has its keys and reads correct; with the timed path
broken underneath (a token altered where it is produced, half of each
batch left out, a step that leaves its state unchanged, a segment lost
by the VAD) it reads not correct."""
import json

import pytest
import torch

import bench_tiny
from benchmark.lib import harness

CELLS = bench_tiny.cells()
CPU = torch.device("cpu")


def run(cell_name, seed=2147483700):
    return harness.run(bench_tiny.cell(cell_name), seed, 1.0, False, CPU)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run(name):
    out = run(name)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())


def altered_token(monkeypatch, family):
    if family == "paraformer":
        from asr2pass_tpu_torch.models import paraformer as mod
    else:
        from asr2pass_tpu_torch.models import sensevoice as mod
    greedy = mod.greedy_ids

    def wrong(*a, **kw):
        out = list(greedy(*a, **kw))
        out[0] = out[0].clone()
        out[0][:, 0] = (out[0][:, 0] + 5) % 60 + 4
        return tuple(out)
    monkeypatch.setattr(mod, "greedy_ids", wrong)


def half_batch(monkeypatch, family):
    if family == "paraformer":
        from asr2pass_tpu_torch.runtime.offline_asr import \
            ParaformerOffline as cls
    else:
        from asr2pass_tpu_torch.runtime.sensevoice_asr import \
            SenseVoiceOffline as cls
    forward = cls._forward

    def halved(self, feats, lengths, *a, **kw):
        lengths = [0 if k % 2 == 0 else n for k, n in enumerate(lengths)]
        return forward(self, feats, lengths, *a, **kw)
    monkeypatch.setattr(cls, "_forward", halved)


def state_unchanged(monkeypatch, family):
    if family == "paraformer":
        from asr2pass_tpu_torch.models import sanm_decoder as mod
        monkeypatch.setattr(mod, "_block",
                            lambda layer, x, *a, **kw: (x, None))
    else:
        from asr2pass_tpu_torch.models import sanm_encoder as mod
        block = mod._block
        calls = []

        def skip_every_other(layer, x, *a, **kw):
            calls.append(1)
            return block(layer, x, *a, **kw) if len(calls) % 2 else x
        monkeypatch.setattr(mod, "_block", skip_every_other)


def lost_segment(monkeypatch, family):
    from asr2pass_tpu_torch.runtime import offline_api
    segs = offline_api.vad_segments_offline
    monkeypatch.setattr(offline_api, "vad_segments_offline",
                        lambda *a, **kw: segs(*a, **kw)[:-1] or segs(*a, **kw))


@pytest.mark.parametrize("fault", [altered_token, half_batch, state_unchanged,
                                   lost_segment])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    family = bench_tiny.cell(name).config["family"]
    fault(monkeypatch, family)
    out = run(name)
    assert not out["correct"], out["checks"]
