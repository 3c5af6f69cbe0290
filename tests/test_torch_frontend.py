"""The port's front-end (fbank, LFR, CMVN, the fused device front-end and
the audio helpers) against the JAX package on the CPU.

Tolerance of the log-mel features: atol 1e-3, and a mean absolute error
under 1e-5. Both take fp32 DFT products over 400 samples of int16-range
audio in another summation order, then a log. Most bins carry power far
above the rounding of those sums (log error ~1e-6); the few low bins left
after DC removal and preemphasis sum terms that cancel, and there the
relative power error, which is the log error, reaches a few 1e-4.
"""
import io
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.config import FrontendConfig as JFrontendConfig
from asr2pass_tpu.frontend import audio as jaudio
from asr2pass_tpu.frontend import fbank as jfbank
from asr2pass_tpu.frontend import lfr as jlfr
from asr2pass_tpu.runtime import streaming_frontend as jsf
from asr2pass_tpu_torch.config import FrontendConfig as TFrontendConfig
from asr2pass_tpu_torch.frontend import audio as taudio
from asr2pass_tpu_torch.frontend import fbank as tfbank
from asr2pass_tpu_torch.frontend import lfr as tlfr
from asr2pass_tpu_torch.runtime import streaming_frontend as tsf

ATOL = 1e-3
MEAN_ERR = 1e-5


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert got.size == 0 or np.abs(got - ref).mean() < MEAN_ERR


def _speechy(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
    x += 0.05 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


@pytest.mark.parametrize("window", ["hamming", "povey", "hanning"])
def test_frames_to_mel(window):
    """DC removal, 0.97 preemphasis, window folded into the DFT, mel bins,
    float32-eps log floor (all-zero frames hit the floor)."""
    frames = np.random.default_rng(0).integers(
        -20000, 20000, (33, 400)).astype(np.float32)
    frames[3] = 0.0
    jex = jfbank.FbankExtractor(JFrontendConfig(window=window))
    tex = tfbank.FbankExtractor(TFrontendConfig(window=window))
    ref = np.asarray(jex.frames_to_mel(jnp.asarray(frames)))
    got = tex.frames_to_mel(torch.from_numpy(frames)).numpy()
    assert got[3].max() == np.float32(np.log(np.finfo(np.float32).eps))
    _close(got, ref)


@pytest.mark.parametrize("seconds", [0.01, 1.0, 2.37])
def test_offline_frontend(seconds):
    """One-shot fbank -> LFR -> CMVN, including too-short audio."""
    x = _speechy(seconds, 1)
    cfg_j, cfg_t = JFrontendConfig(), TFrontendConfig()
    rng = np.random.default_rng(2)
    means = rng.standard_normal(560).astype(np.float32)
    vars_ = rng.uniform(0.5, 2, 560).astype(np.float32)
    ref = jsf.offline_frontend(x, cfg_j, means, vars_)
    got = tsf.offline_frontend(x, cfg_t, means, vars_, device="cpu")
    assert got.shape == ref.shape
    _close(got, ref)


def test_offline_frontend_device():
    """int16 upload, fbank, LFR taps clamped per item to n_mel-1, CMVN;
    three items of different lengths plus a padding row (batch 4)."""
    cfg_j, cfg_t = JFrontendConfig(), TFrontendConfig()
    bufs = [_speechy(s, 10 + i) for i, s in enumerate((3.6, 1.1, 2.5))]
    ns = [tfbank.num_frames(len(b), cfg_t) for b in bufs]
    assert ns == [jfbank.num_frames(len(b), cfg_j) for b in bufs]
    means = np.full(560, -8.0, np.float32)
    vars_ = np.full(560, 0.3, np.float32)
    ref = np.asarray(jsf.offline_frontend_device(
        bufs, ns, 64, cfg_j, means, vars_, batch_b=4))
    got = tsf.offline_frontend_device(bufs, ns, 64, cfg_t, means, vars_,
                                      batch_b=4, device="cpu").numpy()
    assert got.shape == ref.shape == (4, 64, 560)
    _close(got, ref)
    assert tsf.offline_window_samples(cfg_t, 64) == \
        jsf.offline_window_samples(cfg_j, 64)


@pytest.mark.parametrize("n_mel,m,n", [(1, 7, 6), (100, 7, 6), (37, 5, 1)])
def test_lfr_cmvn_copies(n_mel, m, n):
    mel = np.random.default_rng(n_mel).standard_normal(
        (n_mel, 80)).astype(np.float32)
    assert tlfr.lfr_len(n_mel, m, n) == jlfr.lfr_len(n_mel, m, n)
    ref = np.asarray(jlfr.apply_lfr(mel, m, n))
    got = np.asarray(tlfr.apply_lfr(mel, m, n))
    np.testing.assert_array_equal(got, ref)
    means = np.ones(got.shape[1], np.float32)
    np.testing.assert_array_equal(
        np.asarray(tlfr.apply_cmvn(got, means, 2 * means)),
        np.asarray(jlfr.apply_cmvn(ref, means, 2 * means)))


def test_audio_helpers(tmp_path):
    x = _speechy(0.3, 4) * 1.5
    np.testing.assert_array_equal(taudio.quantize_pcm(x),
                                  jaudio.quantize_pcm(x))
    means = np.linspace(-3, 3, 560).astype(np.float32)
    vars_ = np.linspace(0.1, 2, 560).astype(np.float32)
    path = str(tmp_path / "am.mvn")
    taudio.write_kaldi_cmvn(path, means, vars_)
    for got, ref in zip(taudio.parse_kaldi_cmvn(path),
                        jaudio.parse_kaldi_cmvn(path)):
        np.testing.assert_array_equal(got, ref)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x.clip(-1, 1) * 32767).astype("<i2").tobytes())
    got, fs = taudio.load_wav_bytes(buf.getvalue())
    ref, fs_ref = jaudio.load_wav_bytes(buf.getvalue())
    assert fs == fs_ref == 16000
    np.testing.assert_array_equal(got, ref)


def test_load_pcm_bytes():
    """s16le bytes, an odd trailing byte dropped, as the JAX package."""
    x = (_speechy(0.2, 5) * 32767).astype("<i2").tobytes() + b"\x01"
    np.testing.assert_array_equal(taudio.load_pcm_bytes(x),
                                  jaudio.load_pcm_bytes(x))


@pytest.mark.parametrize("fs_in,fs_out", [(8000, 16000), (44100, 16000),
                                          (16000, 22050), (16000, 16000)])
def test_linear_resample(fs_in, fs_out, monkeypatch):
    """The numpy windowed-sinc resampler against the JAX package's numpy
    path (its native C++ branch turned off): equal samples."""
    from asr2pass_tpu.native import bindings

    monkeypatch.setattr(bindings, "available", lambda: False)
    x = _speechy(0.25, 6)
    got = taudio.linear_resample(x, fs_in, fs_out, native=False)
    ref = jaudio.linear_resample(x, fs_in, fs_out)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fs_in,fs_out", [(8000, 16000), (44100, 16000),
                                          (16000, 22050), (16000, 16000)])
def test_linear_resample_default(fs_in, fs_out):
    """The port's default (the native resampler) against the JAX
    package's default (its native resampler): equal samples."""
    from asr2pass_tpu.native import bindings

    assert bindings.available()
    x = _speechy(0.25, 6)
    got = taudio.linear_resample(x, fs_in, fs_out)
    ref = jaudio.linear_resample(x, fs_in, fs_out)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_load_audio_file(tmp_path, monkeypatch):
    """.pcm read as s16le; .wav at 8 kHz resampled to 16 kHz."""
    from asr2pass_tpu.native import bindings

    monkeypatch.setattr(bindings, "available", lambda: False)
    x = (_speechy(0.3, 7) * 32767).astype("<i2")
    pcm = tmp_path / "a.pcm"
    pcm.write_bytes(x.tobytes())
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(x.tobytes())
    for path in (pcm, wav):
        np.testing.assert_array_equal(taudio.load_audio_file(str(path)),
                                      jaudio.load_audio_file(str(path)))
    assert len(taudio.load_audio_file(str(wav))) == 2 * len(x)


def test_load_audio_file_default(tmp_path):
    """The 8 kHz .wav of test_load_audio_file through both packages'
    defaults (their native resamplers): equal samples."""
    x = (_speechy(0.3, 7) * 32767).astype("<i2")
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(x.tobytes())
    got = taudio.load_audio_file(str(wav))
    np.testing.assert_array_equal(got, jaudio.load_audio_file(str(wav)))
    assert len(got) == 2 * len(x)
