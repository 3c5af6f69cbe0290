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
1e-5.
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
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream as TVadStream
from asr2pass_tpu_torch.runtime.vad_stream import (
    vad_segments_offline as tsegments)
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
