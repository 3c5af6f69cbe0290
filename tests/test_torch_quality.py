"""The port's data-quality tools (asr2pass_tpu_torch/tools/quality.py,
segment_filter.py) against the JAX package's, on the CPU.

quality: the SNR, clipping and mel front-end functions equal JAX's on
the same seeded audio (within 1e-6), the cases of tests/test_tools.py
hold, and DnsmosScorer scores hand-encoded graphs with the DNSMOS
models' input and output contract (tests/torch_onnx_fixtures.
dnsmos_graphs) as JAX's does, within 1e-5. segment_filter: over tiny
recognizers with the same weights (the JAX init, carried across with
params_from_jax) and a VAD, the kept segments and their CERs equal
JAX's, with references and with a second recognizer as the gate.
"""
import dataclasses

import jax
import numpy as np
import pytest

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime.offline_api import (
    OfflineRecognizer as JOfflineRecognizer)
from asr2pass_tpu.runtime.offline_asr import (
    ParaformerOffline as JParaformerOffline)
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu.tools import quality as jq
from asr2pass_tpu.tools import segment_filter as jsf
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.offline_api import (
    OfflineRecognizer as TOfflineRecognizer)
from asr2pass_tpu_torch.runtime.offline_asr import (
    ParaformerOffline as TParaformerOffline)
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from asr2pass_tpu_torch.tools import quality as tq
from asr2pass_tpu_torch.tools import segment_filter as tsf
from torch_parity import bursty, dnsmos_graphs, jax_params, tiny_cfgs

FS = 16000


def _waves():
    rng = np.random.default_rng(0)
    t = np.arange(32000) / FS
    tone = np.sin(2 * np.pi * 300 * t).astype(np.float32)
    clean = tone * (np.repeat(rng.random(20) > 0.5, 1600)).astype(np.float32)
    clean += rng.standard_normal(32000).astype(np.float32) * 1e-4
    noisy = clean + rng.standard_normal(32000).astype(np.float32) * 0.5
    clipped = np.clip(noisy * 3, -1, 1)
    return {"clean": clean, "noisy": noisy, "clipped": clipped,
            "short": clean[:100], "empty": clean[:0]}


@pytest.mark.parametrize("name", sorted(_waves()))
def test_snr_and_clipping_equal_jax(name):
    w = _waves()[name]
    assert tq.estimate_snr(w) == pytest.approx(jq.estimate_snr(w), abs=1e-6)
    assert tq.clipping_ratio(w) == jq.clipping_ratio(w)
    for kw in ({}, {"min_snr_db": 5.0, "max_clip": 0.2}):
        assert tq.passes_quality(w, **kw) == jq.passes_quality(w, **kw)


def test_snr_separates_clean_and_noisy():
    """tests/test_tools.py's case, on the port."""
    w = _waves()
    assert tq.estimate_snr(w["clean"]) > tq.estimate_snr(w["noisy"])
    assert tq.estimate_snr(w["clean"]) > 30


def test_clipping_detector():
    """tests/test_tools.py's case, on the port."""
    x = np.zeros(1000, np.float32)
    assert tq.clipping_ratio(x) == 0.0
    x[:100] = 1.0
    assert tq.clipping_ratio(x) == 0.1
    assert not tq.passes_quality(x)
    assert tq.clipping_ratio(x[:0]) == 1.0


@pytest.mark.parametrize("n_mels,n_fft,fs", [(120, 321, 16000),
                                             (40, 512, 8000)])
def test_mel_filterbank_equals_jax(n_mels, n_fft, fs):
    np.testing.assert_allclose(tq._slaney_mel_fb(n_mels, n_fft, fs),
                               jq._slaney_mel_fb(n_mels, n_fft, fs),
                               rtol=0, atol=1e-6)


def test_melspec_db_equals_jax():
    audio = (np.random.default_rng(1).standard_normal(int(9.01 * FS))
             * 0.1).astype(np.float32)
    want = jq._melspec_db(audio[:-160])
    got = tq._melspec_db(audio[:-160])
    assert got.shape == want.shape == (900, 120)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dnsmos_dir(tmp_path_factory):
    return dnsmos_graphs(tmp_path_factory.mktemp("dnsmos"))


@pytest.mark.parametrize("seconds,fs", [(10.0, 16000), (4.0, 16000),
                                        (11.5, 8000)])
def test_dnsmos_scores_equal_jax(dnsmos_dir, seconds, fs):
    """Long, short (repeated to 9.01 s) and 8 kHz (resampled) audio:
    every score within 1e-5 of JAX's, P.808 and the P.835 triple."""
    rng = np.random.default_rng(int(seconds * 10))
    audio = (rng.standard_normal(int(seconds * fs)) * 0.1).astype(np.float32)
    want = jq.DnsmosScorer(dnsmos_dir).score(audio, fs)
    got = tq.DnsmosScorer(dnsmos_dir, device="cpu").score(audio, fs)
    assert got.keys() == want.keys() == {"p808_mos", "sig", "bak", "ovrl"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_dnsmos_empty_audio_ends_with_zero(dnsmos_dir):
    got = tq.DnsmosScorer(dnsmos_dir, device="cpu").score(
        np.zeros(0, np.float32))
    assert got == {"p808_mos": 0.0, "sig": 0.0, "bak": 0.0, "ovrl": 0.0}


def test_dnsmos_runs_on_the_card_unless_asked_for_the_cpu(dnsmos_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.DnsmosScorer(dnsmos_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.main(["--scp", "/nonexistent.scp", "--dnsmos-dir", dnsmos_dir])


# -- segment_filter ------------------------------------------------------------

# digital silence around three speech-like bursts of 1.3-2.2 s
_BURSTS = ((0.4, 0), (2.2, 1), (1.2, 0), (1.3, 1), (1.1, 0), (1.6, 1),
           (0.9, 0))


@pytest.fixture(scope="module")
def recognizers():
    """{name: (JAX recognizer, port recognizer)} over the same weights:
    `primary` and `cross` (another seed), each with the VAD whose energy
    gate alone decides (decibel_thres -30 dB)."""
    jcfg, tcfg = tiny_cfgs(timestamp=True)
    vocab = make_test_vocab(jcfg.vocab_size)
    vad_j = dataclasses.replace(jconfig.vad_default(), decibel_thres=-30.0)
    vad_t = dataclasses.replace(tconfig.vad_default(), decibel_thres=-30.0)
    vad_tree = jax.tree.map(np.asarray,
                            jvad.init(jax.random.PRNGKey(2), vad_j))
    rng = np.random.default_rng(4)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    out = {}
    for name, seed in (("primary", 1), ("cross", 7)):
        tree = jax_params(jcfg, seed)
        out[name] = (
            JOfflineRecognizer(JParaformerOffline(tree, jcfg, vocab,
                                                  cmvn=cmvn),
                               vad_params=vad_tree, vad_cfg=vad_j),
            TOfflineRecognizer(TParaformerOffline(
                params_from_jax(tree), tcfg, TVocab(vocab.tokens),
                cmvn=cmvn, device="cpu"),
                vad_params=params_from_jax(vad_tree), vad_cfg=vad_t))
    return out


def _changed(text: str, k: int) -> str:
    """`text` with k of its tokens replaced: beyond the gates when k is
    large enough."""
    return "".join("X" if i < k else c for i, c in enumerate(text))


def test_segment_filter_equals_jax(recognizers):
    """References = the recognizer's own texts keep every segment with
    CER 0; a reference with its tokens changed beyond the gates drops its
    segment; a second recognizer as the gate keeps what JAX keeps. The
    kept (start, end, text, CER) equal JAX's in every case."""
    (jrec, trec), (jcross, tcross) = (recognizers["primary"],
                                      recognizers["cross"])
    wave = bursty(_BURSTS, 6)
    own = [t for t, _ in jrec.asr.recognize_batch(
        [wave[s * FS // 1000: e * FS // 1000]
         for s, e in jrec.transcribe(wave).segments])]
    assert len(own) == 3 and all(own)
    refs = list(own)
    refs[1] = _changed(refs[1], max(3, len(refs[1])))
    for kw in ({"ref_texts": own}, {"ref_texts": refs}, {}):
        want = jsf.filter_segments(jrec, wave, FS, **kw)
        got = tsf.filter_segments(trec, wave, FS, **kw)
        assert got == want
    kept_own = tsf.filter_segments(trec, wave, FS, ref_texts=own)
    assert [k[3] for k in kept_own] == [0.0] * 3
    kept = tsf.filter_segments(trec, wave, FS, ref_texts=refs)
    assert [k[2] for k in kept] == [own[0], own[2]]
    want = jsf.filter_segments(jrec, wave, FS, cross_recognizer=jcross)
    got = tsf.filter_segments(trec, wave, FS, cross_recognizer=tcross)
    assert got == want


def test_segment_filter_cross_model_gate():
    """tests/test_tools.py::test_segment_filter_cross_model_gate on the
    port: kept only where the second model agrees within ins+del < 2 and
    CER <= 30%."""
    segs = [(0, 1000), (1200, 2400), (2600, 3600)]

    class _Asr:
        def __init__(self, texts):
            self.texts = texts

        def recognize_batch(self, seg_audio):
            assert len(seg_audio) == len(self.texts)
            return [(t, []) for t in self.texts]

    class _Rec:
        def __init__(self, texts, spans=segs):
            self.asr = _Asr(texts)
            self.spans = spans

        def transcribe(self, wave):
            return type("Res", (), {"segments": self.spans})()

    wave = np.zeros(FS * 4, np.float32)
    kept = tsf.filter_segments(
        _Rec(["你好世界", "完全不同的句子", "再见了"]), wave, FS,
        cross_recognizer=_Rec(["你好世界", "某个别的东西啊", "再见了"]))
    assert [t for _, _, t, _ in kept] == ["你好世界", "再见了"]
    kept2 = tsf.filter_segments(
        _Rec(["你好世界啊"], [(0, 1000)]), wave, FS,
        cross_recognizer=_Rec(["你好世界的"], [(0, 1000)]))
    assert len(kept2) == 1 and kept2[0][3] <= 0.30


def test_segment_filter_cli_writes_kaldi_data(tmp_path, recognizers):
    """The CLI on a seeded WAV with a reference file, on the CPU: the
    kaldi files name the kept segments; without --device cpu it raises
    (no card here)."""
    import wave as wave_mod

    import torch

    from asr2pass_tpu_torch.runtime import model_zoo

    trec = recognizers["primary"][1]
    model_dir = tmp_path / "model"
    model_zoo.save_offline_bundle(str(model_dir), trec.asr.model,
                                  trec.asr.cfg, trec.asr.vocab.tokens,
                                  trec.asr.cmvn)
    model_zoo.save_vad_dir(str(tmp_path / "vad"), trec.vad_params,
                           trec.vad_cfg)
    audio = bursty(_BURSTS, 6)
    wav = tmp_path / "u0.wav"
    with wave_mod.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes((audio * 32767).astype("<i2").tobytes())
    (tmp_path / "wav.scp").write_text(f"u0 {wav}\n")
    argv = ["--scp", str(tmp_path / "wav.scp"), "--model-dir",
            str(model_dir), "--vad-dir", str(tmp_path / "vad"),
            "--output-dir", str(tmp_path / "out")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsf.main(argv)
    assert tsf.main(argv + ["--device", "cpu"]) == 0
    segments = (tmp_path / "out" / "segments").read_text().splitlines()
    text = (tmp_path / "out" / "text").read_text().splitlines()
    assert len(segments) == len(text) == 3
    assert all(line.startswith("u0_") for line in text)
