"""The port's 2pass session against the JAX package on the CPU: the
audio splitter, TwoPassSession in its three modes with a real FSMN-VAD,
both Paraformers and punctuation, and the offline recognizer with VAD
and punctuation.

Weights come from the JAX `init` (vad_default, paraformer_tiny for pass
1, paraformer_tiny with the bicif timestamp head for pass 2, punc_tiny)
and reach the port through `params_from_jax`. Every output must be
equal: partial and final text, timestamps, sentence records, segments.
"""
import dataclasses

import jax
import numpy as np
import pytest

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import ct_transformer as jct
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime.asr_stream import (
    ParaformerOnlineStream as JOnlineStream)
from asr2pass_tpu.runtime.audio_splitter import (
    TwoPassSplitter as JSplitter)
from asr2pass_tpu.runtime.offline_api import (
    OfflineRecognizer as JOfflineRecognizer)
from asr2pass_tpu.runtime.offline_asr import (
    ParaformerOffline as JParaformerOffline)
from asr2pass_tpu.runtime.punc import Punctuator as JPunctuator
from asr2pass_tpu.runtime.two_pass import TwoPassSession as JSession
from asr2pass_tpu.runtime.vad_stream import FsmnVadStream as JVadStream
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.runtime.asr_stream import (
    ParaformerOnlineStream as TOnlineStream)
from asr2pass_tpu_torch.runtime.audio_splitter import (
    TwoPassSplitter as TSplitter)
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.offline_api import (
    OfflineRecognizer as TOfflineRecognizer)
from asr2pass_tpu_torch.runtime.offline_asr import (
    ParaformerOffline as TParaformerOffline)
from asr2pass_tpu_torch.runtime.punc import Punctuator as TPunctuator
from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession as TSession
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream as TVadStream
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer as TTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import bursty, jax_params, tiny_cfgs

DECIBEL_THRES = -30.0      # digital silence -60 dB, the bursts ~0 dB
PUNC_TOKENS = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]


# -- the splitter, on the event patterns of tests/test_two_pass.py ---------

def _frames_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.data, r.data)
        assert (g.is_final, g.global_start, g.global_end, g.samp_start,
                g.samp_end) == (r.is_final, r.global_start, r.global_end,
                                r.samp_start, r.samp_end)


_PATTERNS = {
    "closed_segment": [(np.arange(32000) / 32000, [[100, 900]])],
    "open_then_close": [(np.ones(16000), [[200, -1]]),
                        (np.ones(16000), []),
                        (np.ones(4800), [[-1, 2100]])],
    "ring_trim_keeps_open_segment": (
        [(np.ones(16000), [[100, -1]])] + [(np.ones(16000), [])] * 5
        + [(np.ones(16000), [[-1, 6900]])]),
    "close_without_open": [(np.ones(16000), [[-1, 500]]),
                           (np.ones(8000), [[300, -1], [-1, 1400]])],
}


@pytest.mark.parametrize("mode", ["2pass", "online", "offline"])
@pytest.mark.parametrize("pattern", list(_PATTERNS))
def test_splitter(pattern, mode):
    js, ts = JSplitter(16000), TSplitter(16000)
    for wave, events in _PATTERNS[pattern]:
        wave = np.asarray(wave, np.float32)
        ref = js.feed(wave, events, chunk_len=9600, mode=mode)
        got = ts.feed(wave, events, chunk_len=9600, mode=mode)
        for g, r in zip(got, ref):
            _frames_equal(g, r)
        assert (ts.offset, ts.speech_start, ts.speech_end) == (
            js.offset, js.speech_start, js.speech_end)


# -- the session -------------------------------------------------------------

# digital silence around three speech-like bursts of 1.3-2.2 s
_BURSTS = ((0.4, 0), (2.2, 1), (1.2, 0), (1.3, 1), (1.1, 0), (1.6, 1),
           (0.9, 0))


@pytest.fixture(scope="module")
def models():
    on_j, on_t = tiny_cfgs()
    off_j, off_t = tiny_cfgs(timestamp=True)
    on_tree, off_tree = jax_params(on_j, 0), jax_params(off_j, 1)
    vad_j = dataclasses.replace(jconfig.vad_default(),
                                decibel_thres=DECIBEL_THRES)
    vad_t = dataclasses.replace(tconfig.vad_default(),
                                decibel_thres=DECIBEL_THRES)
    vad_tree = jax.tree.map(np.asarray,
                            jvad.init(jax.random.PRNGKey(2), vad_j))
    punc_j, punc_t = jconfig.punc_tiny(300), tconfig.punc_tiny(300)
    punc_tree = jax.tree.map(np.asarray,
                             jct.init(jax.random.PRNGKey(3), punc_j))
    vocab = make_test_vocab(on_j.vocab_size)
    rng = np.random.default_rng(4)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    jax_side = dict(
        vad=lambda: JVadStream(vad_tree, vad_j),
        online=lambda: JOnlineStream(on_tree, on_j, vocab, cmvn=cmvn),
        offline=JParaformerOffline(off_tree, off_j, vocab, cmvn=cmvn),
        punc=JPunctuator(punc_tree, punc_j, JTokenizer(PUNC_TOKENS)),
        vad_tree=vad_tree, vad_cfg=vad_j)
    port_side = dict(
        vad=lambda: TVadStream(params_from_jax(vad_tree), vad_t,
                               device="cpu"),
        online=lambda: TOnlineStream(params_from_jax(on_tree), on_t,
                                     TVocab(vocab.tokens), cmvn=cmvn,
                                     device="cpu"),
        offline=TParaformerOffline(params_from_jax(off_tree), off_t,
                                   TVocab(vocab.tokens), cmvn=cmvn,
                                   device="cpu"),
        punc=TPunctuator(params_from_jax(punc_tree), punc_t,
                         TTokenizer(PUNC_TOKENS), device="cpu"),
        vad_tree=params_from_jax(vad_tree), vad_cfg=vad_t)
    return jax_side, port_side


def _run(side, session_cls, mode, wave):
    sess = session_cls(side["vad"](), side["online"](), side["offline"],
                       punc=side["punc"], mode=mode)
    out = []
    cuts = list(range(0, len(wave), 9600)) + [len(wave)]
    for a, b in zip(cuts[:-1], cuts[1:]):
        out.append(dataclasses.asdict(sess.feed(wave[a:b],
                                                is_final=b == len(wave))))
    return out


@pytest.mark.parametrize("mode", ["2pass", "online", "offline"])
def test_session_matches(models, mode):
    """600 ms messages, the last final: every step's partial text, final
    text, online-mode text, timestamps and sentence records are equal."""
    jax_side, port_side = models
    wave = bursty(_BURSTS, 3)
    ref = _run(jax_side, JSession, mode, wave)
    got = _run(port_side, TSession, mode, wave)
    assert got == ref
    if mode != "offline":
        assert "".join(r["partial"] for r in ref)
    if mode == "online":
        assert "".join(r["online_final"] for r in ref)
    if mode != "online":
        finals = [r for r in ref if r["final_text"]]
        assert len(finals) == 3
        assert all(r["timestamps"] and r["stamp_sents"] for r in finals)


def test_offline_recognizer_with_vad_and_punc(models):
    """Whole-file transcription: VAD segments, text with punctuation,
    timestamps and sentence records equal the JAX recognizer's."""
    jax_side, port_side = models
    wave = bursty(_BURSTS, 6)
    res = []
    for side, cls in ((jax_side, JOfflineRecognizer),
                      (port_side, TOfflineRecognizer)):
        rec = cls(side["offline"], vad_params=side["vad_tree"],
                  vad_cfg=side["vad_cfg"], punc=side["punc"])
        res.append(dataclasses.asdict(rec.transcribe(wave)))
    ref, got = res
    assert got == ref
    assert len(ref["segments"]) == 3 and ref["text"] and ref["stamp_sents"]
