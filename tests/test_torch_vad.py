"""The port's VAD against the JAX package on the CPU: the FSMN-VAD net
with caches, the E2E decision automaton, the per-stream VAD and the
offline segmenter.

The net's weights come from the JAX `init` of vad_default() (FunASR's
FSMN-VAD widths), carried across with `params_from_jax`. The automaton
is compared with both of the JAX package's paths: its Python automaton
(ASR2PASS_NATIVE_VAD=0) and its default, the C++ automaton where the
native library is built; and both of the port's: its default, its own
build of the C++ automaton, and its plain Python frame loop
(native=False). Events must be equal; the net is held to rtol/atol
1e-5. The offline segmenter, which runs the front-end and the net once a
file, is also held to the 1 s FsmnVadStream loop it replaced: equal
segments, and equal automaton inputs window by window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime.vad_stream import FsmnVadStream as JVadStream
from asr2pass_tpu.runtime.vad_stream import (
    vad_segments_offline as jsegments)
from asr2pass_tpu.vad import e2e_vad as je2e
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import fsmn_vad as tvad
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream as TVadStream
from asr2pass_tpu_torch.runtime.vad_stream import (
    vad_segments_offline as tsegments, window_rows)
from asr2pass_tpu_torch.vad import e2e_vad as te2e
from torch_parity import bursty, t

TOL = dict(rtol=1e-5, atol=1e-5)
# digital silence reads -60 dB, the bursts below about 0 dB
DECIBEL_THRES = -30.0


@pytest.fixture(scope="module")
def vad():
    cfg = jconfig.vad_default()
    tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(0), cfg))
    sd = params_from_jax(tree)
    return cfg, tree, sd, tvad.from_state_dict(sd, tconfig.vad_default(),
                                               device="cpu")


def test_vad_config_copies():
    assert (dataclasses.asdict(tconfig.vad_default())
            == dataclasses.asdict(jconfig.vad_default()))
    cfg = tconfig.vad_default()
    assert (cfg.input_dim, cfg.proj_dim, cfg.fsmn_layers, cfg.lorder,
            cfg.hidden_dim, cfg.output_dim) == (400, 128, 4, 20, 250, 248)


def test_fsmn_vad_apply(vad):
    """Three padded chunks with valid_len, then the same frames in one
    call with no valid_len: posteriors and every block's cache."""
    cfg, tree, _, model = vad
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 30, cfg.input_dim)).astype(np.float32)
    jc = jvad.init_caches(cfg, 2)
    tc = tvad.init_caches(tconfig.vad_default(), 2, device="cpu")
    assert [tuple(c.shape) for c in tc] == [(2, 19, 128)] * 4
    pos = np.zeros(2, int)
    for lens in ([12, 7], [7, 11], [11, 12]):
        chunk = np.zeros((2, 15, cfg.input_dim), np.float32)
        for b, n in enumerate(lens):
            chunk[b, :n] = feats[b, pos[b]: pos[b] + n]
        jp, jc = jvad.apply(tree, jnp.asarray(chunk), jc,
                            jnp.asarray(lens))
        tp, tc = tvad.apply(model, t(chunk), tc, torch.tensor(lens))
        for b, n in enumerate(lens):
            np.testing.assert_allclose(tp[b, :n].numpy(),
                                       np.asarray(jp)[b, :n], **TOL)
        for a, r in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
        pos += lens
    jp, jc = jvad.apply(tree, jnp.asarray(feats), jvad.init_caches(cfg, 2))
    tp, tc = tvad.apply(model, t(feats),
                        tvad.init_caches(tconfig.vad_default(), 2, "cpu"))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    for a, r in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


# -- the automaton ----------------------------------------------------------

def _scores(pattern, sil=0.99, speech=0.01):
    """pattern: (state, n_frames) pairs -> [T, 2] posteriors, pdf 0 the
    silence probability (as tests/test_vad.py builds them)."""
    rows = []
    for state, n in pattern:
        p = sil if state == "sil" else speech
        rows.extend([[p, 1.0 - p]] * n)
    return np.asarray(rows, dtype=np.float32)


def _wave(n_frames, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n_frames * 160 + 240) * scale).astype(
        np.float32)


def _random_case():
    """Random posteriors: runs of silence and speech chunks, one frame in
    ten flipped, over a waveform with quiet stretches: 12 chunks."""
    rng = np.random.default_rng(11)
    chunks = []
    for i in range(12):
        n = int(rng.integers(20, 90))
        sil = i % 3 == 0
        p = np.where(rng.random(n) < 0.1, 1 - sil,
                     float(sil)) * 0.9 + rng.uniform(0, 0.1, n)
        scores = np.stack([p, 1 - p], 1).astype(np.float32)
        wave = _wave(n, seed=100 + i, scale=0.1 if i % 4 else 1e-4)
        chunks.append((scores, wave[: n * 160], {}))
    return chunks


def _constructed_cases():
    return {
        "open_then_close": [
            (_scores([("sil", 30), ("speech", 70)]), _wave(100), {}),
            (_scores([("speech", 20), ("sil", 120)]), _wave(140), {})],
        "max_segment_split": [
            (_scores([("speech", 900)]), _wave(900),
             {"max_single_segment_time": 3000})],
        "all_silence_final": [
            (_scores([("sil", 300)]), np.zeros(300 * 160 + 240, np.float32),
             {})],
        "random": _random_case(),
    }


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("online", [True, False])
@pytest.mark.parametrize("case", ["open_then_close", "max_segment_split",
                                  "all_silence_final", "random"])
def test_automaton_matches(monkeypatch, case, online, native):
    """The same chunks, the last one final, give the same events as the
    JAX package's automaton, on its Python path (native "0") and on its
    default (native "1"); the port's on its default, the native
    automaton."""
    _automaton_case(monkeypatch, case, online, native,
                    te2e.E2EVadStateMachine(te2e.VadOptions()))


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("online", [True, False])
@pytest.mark.parametrize("case", ["open_then_close", "max_segment_split",
                                  "all_silence_final", "random"])
def test_automaton_plain_matches(monkeypatch, case, online, native):
    """test_automaton_matches with the port's plain version, the Python
    frame loop (native=False)."""
    tsm = te2e.E2EVadStateMachine(te2e.VadOptions(), native=False)
    assert tsm._native is None
    _automaton_case(monkeypatch, case, online, native, tsm)


def _automaton_case(monkeypatch, case, online, native, tsm):
    monkeypatch.setenv("ASR2PASS_NATIVE_VAD", native)
    jsm = je2e.E2EVadStateMachine(je2e.VadOptions())
    assert (jsm._native is not None) == (native == "1")
    chunks = _constructed_cases()[case]
    events = []
    for i, (scores, wave, kw) in enumerate(chunks):
        fin = i == len(chunks) - 1
        ref = jsm(scores, wave, is_final=fin, online=online, **kw)
        got = tsm(scores, wave, is_final=fin, online=online, **kw)
        assert got == ref, (i, got, ref)
        events += got
    if case != "all_silence_final":
        assert events


# -- the per-stream VAD and the offline segmenter ---------------------------

# 0.5 s silence, 1.5 s burst, 1.2 s silence, 1.1 s burst, 1.0 s
# silence, 0.7 s burst, 0.6 s silence
_BURSTS = ((0.5, 0), (1.5, 1), (1.2, 0), (1.1, 1), (1.0, 0), (0.7, 1),
           (0.6, 0))


def _cfgs(**kw):
    return (dataclasses.replace(jconfig.vad_default(), **kw),
            dataclasses.replace(tconfig.vad_default(), **kw))


@pytest.mark.parametrize("online", [True, False])
def test_vad_stream_events(vad, online):
    """600 ms messages with an odd-sized one, the last final: the events
    of each accept equal the JAX stream's, one segment per burst."""
    _, tree, sd, _ = vad
    jcfg, tcfg = _cfgs(decibel_thres=DECIBEL_THRES)
    rng = np.random.default_rng(4)
    cmvn = (rng.uniform(-12, -8, 400).astype(np.float32),
            rng.uniform(0.2, 0.4, 400).astype(np.float32))
    js = JVadStream(tree, jcfg, cmvn=cmvn, online=online)
    ts = TVadStream(sd, tcfg, cmvn=cmvn, online=online, device="cpu")
    wave = bursty(_BURSTS, 3)
    cuts = [0, 1234] + list(range(1234 + 9600, len(wave), 9600)) + [len(wave)]
    events = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        fin = b == len(wave)
        ref = js.accept(wave[a:b], fin)
        got = ts.accept(wave[a:b], fin)
        assert got == ref, (a, got, ref)
        events += got
    closed = [e for e in events if e[1] != -1]
    assert len(closed) == 3, events


def test_vad_segments_offline(vad):
    """The 1 s-windowed offline segmenter, with the request overrides
    (tail silence, max segment length): equal closed segments."""
    _, tree, sd, _ = vad
    jcfg, tcfg = _cfgs(decibel_thres=DECIBEL_THRES)
    wave = bursty(_BURSTS, 5)
    for kw in ({}, {"max_end_sil": 500, "max_single_segment": 1000}):
        ref = jsegments(tree, jcfg, wave, **kw)
        got = tsegments(sd, tcfg, wave, device="cpu", **kw)
        assert got == ref
        assert len(got) >= 3


def _long_wave(seconds: float, seed: int) -> np.ndarray:
    """bursty() audio of 0.5-3 s pauses and 1-8 s bursts, cut to
    `seconds`."""
    rng = np.random.default_rng(seed)
    pattern, total = [], 0.0
    while total < seconds:
        pause, burst = rng.uniform(0.5, 3.0), rng.uniform(1.0, 8.0)
        pattern += [(pause, 0), (burst, 1)]
        total += pause + burst
    return bursty(pattern, seed)[: int(seconds * 16000)]


def _windowed_segments(sd, cfg, wave, cmvn, step, **kw):
    """The offline segmenter as a FsmnVadStream.accept loop over windows
    of `step` samples: every window through the streaming front-end, the
    net and the automaton, the events joined into closed segments."""
    stream = TVadStream(sd, cfg, cmvn=cmvn, online=True, device="cpu", **kw)
    events = []
    for off in range(0, len(wave), step):
        events += stream.accept(wave[off: off + step],
                                off + step >= len(wave))
    out, start = [], -1
    for s, e in events:
        if s != -1:
            start = s
        if e != -1 and start != -1:
            out.append([start, e])
            start = -1
    return out


def _equal_to_the_windowed_stream(monkeypatch, sd, cfg, wave, cmvn,
                                  window_s, **kw):
    """Runs the offline segmenter and the windowed stream it replaces:
    equal segments, and the automaton called with the same windows of
    samples, the same options and the same silence posteriors row for
    row. Returns the segments."""
    calls = []
    automaton = te2e.E2EVadStateMachine.__call__

    def record(self, scores, waveform, **a):
        ids = list(self.opts.sil_pdf_ids)
        calls.append((np.asarray(scores)[:, ids].sum(-1, dtype=np.float32),
                      np.asarray(waveform).copy(), a))
        return automaton(self, scores, waveform, **a)

    monkeypatch.setattr(te2e.E2EVadStateMachine, "__call__", record)
    step = int(16000 * window_s)
    ref = _windowed_segments(sd, cfg, wave, cmvn, step, **kw)
    ref_calls, calls[:] = list(calls), []
    got = tsegments(sd, cfg, wave, cmvn=cmvn, window_s=window_s,
                    device="cpu", **kw)
    assert got == ref
    assert len(calls) == len(ref_calls)
    for (sil, w, a), (rsil, rw, ra) in zip(calls, ref_calls):
        np.testing.assert_array_equal(w, rw)
        assert a == ra
        # relative: the silence posterior is held near e^-20
        np.testing.assert_allclose(sil, rsil, rtol=1e-4, atol=0)
    return got


def _held_silence(sd, sil_ids):
    """The net's weights with the silence pdfs' bias at -20, so that the
    energy gate segments."""
    sd = dict(sd, **{"out2.b": sd["out2.b"].clone()})
    sd["out2.b"][list(sil_ids)] = -20.0
    return sd


@pytest.mark.parametrize("variant", ["plain", "cmvn", "cmvn_of_nones",
                                     "two_sil_pdfs"])
@pytest.mark.parametrize("overrides", [False, True])
@pytest.mark.parametrize("seconds", [0.02, 0.5, 3.0, 3.37, 75.3, 130.0])
def test_offline_segments_equal_the_windowed_stream(vad, monkeypatch,
                                                    seconds, overrides,
                                                    variant):
    """The file-at-a-time segmenter against the 1 s stream it replaces
    (130 s crosses two 6000-row net blocks, its caches carried)."""
    sil_ids = (0, 3) if variant == "two_sil_pdfs" else (0,)
    _, cfg = _cfgs(decibel_thres=DECIBEL_THRES, sil_pdf_ids=sil_ids)
    # a VAD dir without am.mvn loads as (None, None)
    cmvn = (None, None) if variant == "cmvn_of_nones" else None
    if variant == "cmvn":
        rng = np.random.default_rng(4)
        cmvn = (rng.uniform(-12, -8, 400).astype(np.float32),
                rng.uniform(0.2, 0.4, 400).astype(np.float32))
    kw = {"max_end_sil": 500, "max_single_segment": 1000} if overrides else {}
    wave = _long_wave(seconds, 9)
    got = _equal_to_the_windowed_stream(
        monkeypatch, _held_silence(vad[2], sil_ids), cfg, wave, cmvn, 1.0,
        **kw)
    if seconds > 60:
        assert len(got) >= 10


@pytest.mark.parametrize("seconds", [3.37, 6.0])
def test_offline_segments_short_windows(vad, monkeypatch, seconds):
    """30 ms windows, the first of which emits no rows (the automaton
    skips it, as FsmnVadStream.accept does)."""
    _, cfg = _cfgs(decibel_thres=DECIBEL_THRES)
    wave = _long_wave(seconds, 10)
    assert window_rows(len(wave), cfg.frontend, 480)[0] == 0
    assert _equal_to_the_windowed_stream(
        monkeypatch, _held_silence(vad[2], (0,)), cfg, wave, None, 0.03,
        max_end_sil=200, max_single_segment=1000)


@pytest.mark.parametrize("frontend", ["vad", "asr"])
@pytest.mark.parametrize("n", [0, 150, 399, 400, 560, 8000, 15999, 16000,
                               16001, 16240, 33337, 48399])
def test_window_rows_match_the_streaming_frontend(frontend, n):
    """window_rows against the rows StreamingFrontend.accept emits for
    each 1 s window, the last final: the VAD's LFR(5,1) and the
    recognizer's LFR(7,6) front-ends, files under one frame and at
    window edges."""
    fcfg = (tconfig.vad_default().frontend if frontend == "vad"
            else tconfig.FrontendConfig())
    fe = StreamingFrontend(fcfg, device="cpu")
    wave = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    emitted = [fe.accept(wave[off: off + 16000], off + 16000 >= n).shape[0]
               for off in range(0, n, 16000)]
    assert window_rows(n, fcfg, 16000) == emitted


def test_vad_dir_round_trip(vad, tmp_path):
    """A VAD dir the port writes loads back in the port with the same
    arrays, configuration and CMVN, and reads in the JAX package as its
    transcribe tool reads one (load_params, load_vad_yaml,
    parse_kaldi_cmvn): the same tree, with `blocks` a list."""
    from asr2pass_tpu.frontend.audio import parse_kaldi_cmvn
    from asr2pass_tpu.runtime.model_zoo import load_params
    from asr2pass_tpu_torch.runtime import model_zoo as tzoo

    _, tree, sd, model = vad
    _, tcfg = _cfgs(decibel_thres=DECIBEL_THRES, max_single_segment_time=9000,
                    sil_pdf_ids=(0, 3))
    cmvn = (np.linspace(-9, -7, 400).astype(np.float32),
            np.linspace(0.1, 0.5, 400).astype(np.float32))
    tzoo.save_vad_dir(str(tmp_path), model, tcfg, cmvn)
    got_sd, got_cfg, got_cmvn = tzoo.load_vad_dir(str(tmp_path))
    assert got_sd.keys() == sd.keys()
    assert all(torch.equal(got_sd[k], v) for k, v in sd.items())
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(tcfg)
    jcfg = jconfig.load_vad_yaml(str(tmp_path / "config.yaml"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtree = load_params(str(tmp_path / "weights.npz"))
    assert isinstance(jtree["blocks"], list) and len(jtree["blocks"]) == 4
    for k, blk in enumerate(tree["blocks"]):
        np.testing.assert_array_equal(jtree["blocks"][k]["taps"],
                                      blk["taps"])
        np.testing.assert_array_equal(jtree["blocks"][k]["proj"]["w"],
                                      blk["proj"]["w"])
    for a, b, c in zip(got_cmvn, parse_kaldi_cmvn(
            str(tmp_path / "am.mvn")), cmvn):
        np.testing.assert_array_equal(a, b)
        # am.mvn is text: a few digits of each value are written
        np.testing.assert_allclose(a, c, rtol=1e-5)


def test_vad_yaml_loader_matches(tmp_path):
    """FunASR's VAD config.yaml keys read the same in both packages."""
    path = tmp_path / "config.yaml"
    path.write_text(
        "frontend_conf: {fs: 16000, n_mels: 80, lfr_m: 5, lfr_n: 1}\n"
        "model_conf: {max_end_silence_time: 500, speech_noise_thres: 0.8,\n"
        "  sil_pdf_ids: [0, 1], decibel_thres: -40}\n"
        "encoder_conf: {proj_dim: 64, linear_dim: 200, lorder: 10}\n")
    assert (dataclasses.asdict(tconfig.load_vad_yaml(str(path)))
            == dataclasses.asdict(jconfig.load_vad_yaml(str(path))))
