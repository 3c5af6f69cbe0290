"""The 2pass cell at a small size on the CPU: a sound run through the
server, the engine and the callers' child process reads correct; with
the served path broken underneath (a pass-1 token altered where the step
produces it, the decoder's state not advanced, a segment dropped on its
way from the VAD to pass 2, a pass-2 token altered where it is produced,
half of each pass-2 batch left out, a final's text altered on its way
out) it reads not correct. The traffic's schedule is the seed's; the
callers' process imports nothing banned; both passes' weights have the
program's layouts; the readers read a run's record, and read nothing
from a program without one; the pass-1 step's FLOPs are the counted
ones."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_tiny
from benchmark.lib import harness, serving, weights
from benchmark.reference import config as rc
from benchmark.reference import online
from benchmark.traffic import paced_2pass

CELL = "plarge-2pass-paced"
CPU = torch.device("cpu")


def cell():
    c = bench_tiny.cell(CELL)
    c.workload["params"].update(callers=4, ramp_s=1, lead_s=2)
    c.config["engine"]["capacity"] = 8
    return c


def run(seed=2147483711):
    return harness.run(cell(), seed, 2.0, False, CPU)


def test_sound_run():
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(out["checks"]) == set(cell().config["limits"])


def altered_token(monkeypatch):
    from asr2pass_tpu_torch.models import paraformer_online as po
    step = po.step

    def wrong(*a, **kw):
        state, ids, counts = step(*a, **kw)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 5) % 60 + 4
        return state, ids, counts
    monkeypatch.setattr(po, "step", wrong)


def state_not_advanced(monkeypatch):
    from asr2pass_tpu_torch.models import paraformer_online as po
    step = po.step

    def stuck(params, cfg, state, *a, **kw):
        new, ids, counts = step(params, cfg, state, *a, **kw)
        return new._replace(dec_caches=state.dec_caches), ids, counts
    monkeypatch.setattr(po, "step", stuck)


def dropped_segment(monkeypatch):
    from asr2pass_tpu_torch.runtime.audio_splitter import TwoPassSplitter
    feed = TwoPassSplitter.feed
    seen = [0]

    def lossy(self, *a, **kw):
        on, off = feed(self, *a, **kw)
        keep = []
        for fr in off:
            seen[0] += 1
            if seen[0] % 2:
                keep.append(fr)
        return on, keep
    monkeypatch.setattr(TwoPassSplitter, "feed", lossy)


def altered_p2_token(monkeypatch):
    from asr2pass_tpu_torch.models import paraformer
    greedy = paraformer.greedy_ids

    def wrong(*a, **kw):
        out = list(greedy(*a, **kw))
        out[0] = out[0].clone()
        out[0][:, 0] = (out[0][:, 0] + 5) % 60 + 4
        return tuple(out)
    monkeypatch.setattr(paraformer, "greedy_ids", wrong)


def half_p2_batch(monkeypatch):
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    forward = ParaformerOffline._forward

    def halved(self, feats, lengths, *a, **kw):
        lengths = [0 if k % 2 == 0 else n for k, n in enumerate(lengths)]
        return forward(self, feats, lengths, *a, **kw)
    monkeypatch.setattr(ParaformerOffline, "_forward", halved)


def altered_text(monkeypatch):
    from asr2pass_tpu_torch.server import ws_server
    send = ws_server.AsrWsServer._send

    async def changed(self, ws, payload):
        if payload.get("mode") == "2pass-offline":
            payload = dict(payload, text=payload["text"] + "x")
        return await send(self, ws, payload)
    monkeypatch.setattr(ws_server.AsrWsServer, "_send", changed)


@pytest.mark.parametrize("fault", [altered_token, state_not_advanced,
                                   dropped_segment, altered_p2_token,
                                   half_p2_batch, altered_text])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


PARAMS = {"callers": 5, "file_seconds": [6, 9], "pool_calls": 4,
          "burst_s": [1.0, 2.5], "pause_s": [0.9, 1.5], "layout_seed": 29,
          "sample_files": 2, "message_ms": 60, "chunk_size": [5, 10, 5],
          "chunk_interval": 10, "ramp_s": 1, "lead_s": 2}


class _Svc:
    port = 0


def test_schedule_is_the_seeds():
    a = paced_2pass.Load(None, _Svc(), PARAMS, 2147483647 + 9, CPU)
    b = paced_2pass.Load(None, _Svc(), PARAMS, 2147483647 + 9, CPU)
    c = paced_2pass.Load(None, _Svc(), PARAMS, 11, CPU)
    assert a.plan == b.plan and a.sampled == b.sampled
    assert all(np.array_equal(x, y) for x, y in zip(a.files, b.files))
    assert a.plan != c.plan or a.sampled != c.sampled
    for x, y in zip(a.files, c.files):          # the layout is shared
        assert len(x) == len(y) and not np.array_equal(x, y)
        assert len(paced_2pass.cut_points(x)) == len(
            paced_2pass.cut_points(y))
        assert np.array_equal(np.round(x * 32768) / 32768, x)
        assert not x[-int(0.9 * 16000):].any()


def test_callers_import_nothing_banned():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('c', "
        f"{str(harness.BENCH / 'traffic' / 'paced_2pass.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "import websockets\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (set(harness.BANNED) | {"torch",
                                                "asr2pass_tpu_torch"})


def test_specs_are_the_program_layouts():
    """Both passes' seeded weights have the program's keys and shapes at
    the configuration's widths (the paraformer family's test, for the
    2pass configuration's two Paraformers)."""
    from asr2pass_tpu_torch import config as pc
    from asr2pass_tpu_torch.models import paraformer as p_par

    from benchmark.families import paraformer, twopass

    node = harness.load_json(harness.BENCH / "configs"
                             / "paraformer-large-2pass.json")
    for ref, prog in ((twopass.online_cfg(rc, node["asr"]),
                       twopass.online_cfg(pc, node["asr"])),
                      (paraformer.asr_cfg(rc, twopass.pass2_node(node)["asr"]),
                       paraformer.asr_cfg(pc,
                                          twopass.pass2_node(node)["asr"]))):
        spec = weights.paraformer(ref)
        model = p_par.Paraformer(prog, device="meta")
        assert {k: tuple(s) for k, (s, _) in spec.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}


def _reader(name):
    return harness.reader(name).read


class _Served:
    audio_s = 10.0
    partial_waits = [0.1 * i for i in range(1, 21)]
    final_waits = [1.0, 2.0, 3.0, 4.0]
    stages = {"tick": [0.01] * 19 + [0.2], "tick_p1_dispatch": [0.002],
              "p2_recognize": [0.05, 0.07]}
    counts = {"engine.p1_rows": 1280, "engine.p1_active": 320}


def test_readers_read_the_record():
    run_ = harness.Run()
    run_.served = _Served()
    run_.trace = {"kernels": 5000, "busy_s": 2.0, "window_s": 8.0}
    run_.flops, run_.peak_flops = 1.6e12, 1e12
    want = {"partial_ms_p95.2pass": 1900.0, "final_ms_p90.2pass": 4000.0,
            "tick_ms_p95.2pass": 10.0, "p1_dispatch_ms_p95.2pass": 2.0,
            "p2_recognize_ms_p95.2pass": 70.0, "slot_occupancy.2pass": 25.0,
            "launches_per_audio_s.2pass": 500.0, "device_idle.2pass": 75.0,
            "mfu.2pass": 20.0}
    for name, value in want.items():
        assert _reader(name)(run_) == pytest.approx(value), name
    bare = harness.Run()
    bare.served = type("W", (), {"audio_s": 10.0})()
    for name in want:
        assert _reader(name)(bare) is None, name


@pytest.mark.parametrize("n", [3, 10])
def test_online_step_flops(n):
    cfg = rc.ParaformerConfig(
        encoder=rc.EncoderConfig(output_size=32, num_blocks=3,
                                 attention_heads=2, linear_units=48),
        decoder=rc.DecoderConfig(num_blocks=2, attention_heads=2,
                                 linear_units=40, sanm_shift=5),
        predictor=rc.PredictorConfig(idim=32), vocab_size=50)
    sd = weights.make(weights.paraformer(cfg), 1, "online", "cpu")
    sd["predictor.out.b"].fill_(2.0)       # fire often
    feats = torch.randn(n, 560)
    out = {}
    with FlopCounterMode(display=False) as m:
        out["r"] = online.pass1(sd, cfg, feats, [(n, True)])
    u = out["r"].counts[0]
    assert u > 0
    assert m.get_total_flops() == serving.online_step_flops(cfg, n, u)
