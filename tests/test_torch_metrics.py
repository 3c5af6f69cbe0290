"""The port's spans, request records and counters (runtime/metrics) on the
CPU: nesting and self time, records kept apart by context, the profiler
range emitted only while a profiler runs and on the profiler's clock, the
newest samples kept, the report's rate over the window since reset(),
and the record of a whole-file transcription at test widths."""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import ct_transformer, fsmn_vad, paraformer
from asr2pass_tpu_torch.models import sensevoice
from asr2pass_tpu_torch.runtime import metrics
from asr2pass_tpu_torch.runtime.metrics import Metrics, StageStats
from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.punc import Punctuator
from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab

OFFLINE_SPANS = {"offline.request", "offline.vad", "vad.setup",
                 "vad.frontend", "vad.net", "vad.automaton", "vad.fetch",
                 "offline.asr", "asr.frontend", "asr.forward", "asr.block",
                 "asr.finish", "asr.cif", "asr.fetch", "offline.punc",
                 "punc.window", "punc.fetch"}


class Clock:
    """time's three clocks, advanced by hand."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def time_ns(self):
        return 1_700_000_000_000_000_000 + self.ns

    def time(self):
        return self.time_ns() / 1e9


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(metrics, "time", c)
    return c


def test_nested_spans_count_total_and_self_time(clock):
    m = Metrics()
    with m.request() as rec:
        with m.stage("outer"):
            clock.ns += 10
            for _ in range(2):
                with m.stage("inner"):
                    clock.ns += 30
                    with m.stage("leaf"):
                        clock.ns += 5
            clock.ns += 7
    assert rec["spans"] == {
        "leaf": {"n": 2, "total_ns": 10, "self_ns": 10},
        "inner": {"n": 2, "total_ns": 70, "self_ns": 60},
        "outer": {"n": 1, "total_ns": 87, "self_ns": 17}}
    assert rec["end_ns"] - rec["start_ns"] == 87
    # the process-wide stages saw the same durations
    assert m.stages["inner"].count == 2
    assert m.stages["outer"].total_s == pytest.approx(87e-9)


def test_records_are_json_with_their_own_ids():
    m = Metrics()
    with m.request() as a:
        with m.stage("s"):
            m.count("c", 3)
    with m.request() as b:
        pass
    assert b["id"] == a["id"] + 1
    assert json.loads(json.dumps(a)) == a
    assert set(a) == {"id", "start_ns", "end_ns", "spans", "counts"}
    assert a["counts"] == {"c": 3} and b["spans"] == {} and b["counts"] == {}


def test_two_threads_keep_their_records_apart():
    m = Metrics()
    both = threading.Barrier(2)
    out = {}

    def work(tag):
        with m.request() as rec:
            for _ in range(3):
                with m.stage(f"{tag}.outer"):
                    both.wait()
                    with m.stage(f"{tag}.inner"):
                        m.count(f"{tag}.count")
                    both.wait()
        out[tag] = rec

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tag in "ab":
        rec = out[tag]
        assert set(rec["spans"]) == {f"{tag}.outer", f"{tag}.inner"}
        assert rec["counts"] == {f"{tag}.count": 3}
        assert rec["spans"][f"{tag}.outer"]["n"] == 3
    assert m.counts == {"a.count": 3, "b.count": 3}


def test_many_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span,
    counter and record update lands, and each record holds its own."""
    m = Metrics()
    n_threads = 2 * (os.cpu_count() or 4)
    rounds = 200
    records = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with m.request() as rec:
                for _ in range(rounds):
                    with m.stage("outer"), m.stage("inner"):
                        m.count("hits")
            records.append(rec)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * rounds
    assert m.counts["hits"] == total
    assert m.stages["outer"].count == m.stages["inner"].count == total
    assert len({rec["id"] for rec in records}) == n_threads
    for rec in records:
        assert rec["counts"] == {"hits": rounds}
        assert rec["spans"]["inner"]["n"] == rec["spans"]["outer"]["n"] \
            == rounds


def test_without_a_record_only_the_stages_record():
    m = Metrics()
    with m.stage("alone"):
        m.count("hits", 2)
    assert m.stages["alone"].count == 1
    assert m.counts["hits"] == 2
    assert metrics._RECORD.get() is None and metrics._OPEN.get() is None


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"host_range({name!r}) entered")

    monkeypatch.setattr(metrics, "host_range", refuse)
    m = Metrics()
    with m.request(), m.stage("a"), m.stage("b"):
        pass
    assert m.stages["b"].count == 1
    # the same span under a profiler does enter it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            with m.stage("a"):
                pass


def test_stage_stats_keep_the_newest_samples():
    st = StageStats()
    for i in range(1500):
        st.add(float(i))
    assert len(st.samples) == 1000
    assert list(st.samples)[0] == 500.0 and st.count == 1500
    assert st.percentile(0) == 500.0 and st.percentile(100) == 1499.0
    assert st.max_s == 1499.0


def test_report_rate_is_over_the_window_since_reset(clock):
    m = Metrics()
    clock.ns += 100 * 10**9
    m.add_audio(50.0)
    with m.stage("s"):
        m.count("c")
    m.reset()
    assert m.audio_seconds == 0.0 and not m.counts and not m.stages
    clock.ns += 4 * 10**9
    m.add_audio(10.0)
    m.count("c", 2)
    rep = m.report()
    assert rep["throughput_audio_s_per_s"] == 2.5
    assert rep["window_s"] == 4.0 and rep["uptime_s"] == 104.0
    assert rep["audio_seconds"] == 10.0 and rep["counts"] == {"c": 2}


# -- the offline path at test widths ----------------------------------------

ASR_TOKENS = ["<blank>", "<s>", "</s>", "<unk>"] + [
    chr(0x4E00 + i) for i in range(60)]
PUNC_TOKENS = ["<blank>", "<unk>"] + ASR_TOKENS[4:] + [
    f"w{i}" for i in range(66)]


def _bursts(seconds: int, seed: int) -> np.ndarray:
    """Whole seconds (4 or more) of audio: two tone bursts between
    pauses of silence."""
    rng = np.random.default_rng(seed)
    wave = np.zeros(16000 * seconds, np.float32)
    t = np.arange(16000 * 1.2) / 16000
    for start in (0.5, 2.3):
        a = int(16000 * start)
        wave[a: a + len(t)] = 0.3 * np.sin(
            2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(len(t))
    return wave


def _vad_state(seed: int):
    """fsmn-vad at its widths, random weights, its silence pdf held low so
    that the decibel gate segments."""
    cfg = dataclasses.replace(tconfig.vad_default(), decibel_thres=-30.0)
    g = torch.Generator().manual_seed(seed)
    sd = fsmn_vad.init(cfg, g, "cpu").state_dict()
    sd["out2.b"][list(cfg.sil_pdf_ids)] = -20.0
    return sd, cfg


def _recognizer(kind: str) -> OfflineRecognizer:
    g = torch.Generator().manual_seed(5)
    if kind == "paraformer":
        cfg = tconfig.paraformer_tiny(len(ASR_TOKENS))
        asr = ParaformerOffline(paraformer.init(cfg, g, "cpu"), cfg,
                                Vocab(ASR_TOKENS), device="cpu")
        pcfg = tconfig.punc_tiny(len(PUNC_TOKENS))
        punc = Punctuator(ct_transformer.init(pcfg, g, "cpu"), pcfg,
                          PuncTokenizer(PUNC_TOKENS), device="cpu")
    else:
        cfg = tconfig.sensevoice_tiny(len(ASR_TOKENS))
        asr = SenseVoiceOffline(sensevoice.init(cfg, g, "cpu"), cfg,
                                Vocab(ASR_TOKENS), device="cpu")
        punc = None
    vad_sd, vad_cfg = _vad_state(6)
    return OfflineRecognizer(asr, vad_params=vad_sd, vad_cfg=vad_cfg,
                             punc=punc)


@pytest.fixture(scope="module")
def paraformer_rec():
    return _recognizer("paraformer")


def test_transcribe_returns_its_span_record(paraformer_rec):
    """Every span of the offline path, each fetch span once a blocking
    copy: one a file's VAD, one a recognize_batch, one a punctuation
    window; the counters hold the VAD's 1 s windows and net calls and
    the chunks' true and padded frames."""
    seconds = 4
    res = paraformer_rec.transcribe(_bursts(seconds, 7), use_itn=False)
    assert len(res.segments) == 2 and res.text
    rec = res.trace
    spans = rec["spans"]
    assert set(spans) == OFFLINE_SPANS
    assert spans["vad.fetch"]["n"] == spans["vad.frontend"]["n"] == 1
    assert spans["vad.net"]["n"] == spans["vad.automaton"]["n"] == 1
    assert rec["counts"]["vad.windows"] == seconds
    assert rec["counts"]["vad.net_calls"] == 1
    assert spans["vad.setup"]["n"] == 1
    assert spans["asr.fetch"]["n"] == 1 and spans["asr.forward"]["n"] == 1
    # each block of the encoder (2) and of the decoder (2)
    assert spans["asr.block"]["n"] == 4
    assert spans["punc.fetch"]["n"] == spans["punc.window"]["n"] >= 1
    assert spans["offline.request"]["n"] == 1
    req = spans["offline.request"]
    assert req["self_ns"] == req["total_ns"] - sum(
        spans[k]["total_ns"] for k in ("offline.vad", "offline.asr",
                                       "offline.punc"))
    assert all(0 <= s["self_ns"] <= s["total_ns"] for s in spans.values())
    assert req["total_ns"] <= rec["end_ns"] - rec["start_ns"]
    # both segments in one chunk of the 64-frame bucket, two rows
    frames = rec["counts"]["asr.frames"]
    assert 0 < frames <= rec["counts"]["asr.frames_padded"] == 2 * 64
    # a result compares by its content, without its record
    assert "trace" not in dataclasses.asdict(res)


def test_sensevoice_transcribe_record():
    res = _recognizer("sensevoice").transcribe(_bursts(4, 8))
    spans = res.trace["spans"]
    assert set(spans) == OFFLINE_SPANS - {"asr.cif", "offline.punc",
                                          "punc.window", "punc.fetch"}
    assert spans["vad.fetch"]["n"] == 1 and spans["asr.fetch"]["n"] == 1
    assert res.trace["counts"]["asr.frames_padded"] == 2 * 64


def test_spans_are_profiler_ranges_on_its_clock(paraformer_rec):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        res = paraformer_rec.transcribe(_bursts(4, 9), use_itn=False)
    events = prof.profiler.kineto_results.events()
    starts, kinds = {}, {}
    for ev in events:
        starts.setdefault(ev.name(), []).append(ev.start_ns())
        kinds[ev.name()] = ev.activity_type()
    assert set(res.trace["spans"]) <= set(starts)
    # host ranges, which the profiler does not draw on a device's timeline
    assert {kinds[k] for k in res.trace["spans"]} == {"cpu_op"}
    assert len(starts["vad.fetch"]) == res.trace["spans"]["vad.fetch"]["n"]
    (at,) = starts["offline.request"]
    assert abs(at - res.trace["start_ns"]) < 1_000_000


def test_stats_show_the_offline_stages(paraformer_rec):
    """The process-wide stages (the server's `stats`) hold the new spans,
    and the counters come out in the report."""
    metrics.GLOBAL.reset()
    paraformer_rec.transcribe(_bursts(4, 10), use_itn=False)
    rep = metrics.GLOBAL.report()
    assert {"offline.vad", "vad.automaton", "asr.cif"} <= set(rep["stages"])
    assert rep["stages"]["vad.fetch"]["count"] == 1
    assert set(rep["counts"]) == {"vad.windows", "vad.net_calls",
                                  "asr.frames", "asr.frames_padded"}
