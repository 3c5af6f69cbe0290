"""The port's hotword compiler and hotword-biased pass 2 against the JAX
package's on the CPU: tokenization and seg_dict, compiled embeddings with
a learned and with a derived null row, mixed hotword batches through
recognize_batch, and a converted hotword model dir (a `hotword_compiler`
subtree beside the Paraformer's weights, no null row) through the
launcher's build_models.

Weights come from the JAX `init` (HotwordConfig(vocab_size=64,
embed_dim=32, hidden_dim=32) alone; hidden_dim 64, the decoder's width,
where the embeddings feed paraformer_tiny's hotword block) and reach the
port through `params_from_jax`. Tolerances: embeddings 1e-5 abs (a
10-step LSTM in fp32); token ids and texts exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import hotword as jhw
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.runtime.offline_asr import (
    ParaformerOffline as JParaformerOffline)
from asr2pass_tpu.server.engine import ServerModels as JServerModels
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import hotword as thw
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.offline_asr import (
    ParaformerOffline as TParaformerOffline)
from asr2pass_tpu_torch.server.run_server import build_models, parser
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import jax_params, tiny_cfgs

EMB_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VOCAB = make_test_vocab(64)
T = VOCAB.id2token


def _seg_dict(mod):
    seg = mod.SegDict()
    seg.map["hello"] = [T(12), T(13)]
    seg.map["world"] = ["wor@@", "ld"]
    return seg


# (word, with seg_dict): CJK, latin with and without a seg_dict entry,
# mixed, whitespace, a word past max_hotword_len, and unknown characters
_WORDS = [T(10) + T(11), "hello", "Hello " + T(20), T(5) + "abc" + T(6),
          "world wide", "".join(T(4 + i) for i in range(14)), "中文", ""]


@pytest.mark.parametrize("use_seg", [False, True])
@pytest.mark.parametrize("word", _WORDS)
def test_tokenize_hotword_matches_jax(word, use_seg):
    tv = TVocab(VOCAB.tokens)
    got = thw.tokenize_hotword(word, tv, _seg_dict(thw) if use_seg else None)
    want = jhw.tokenize_hotword(word, VOCAB,
                                _seg_dict(jhw) if use_seg else None)
    assert got == want


def test_seg_dict_file_matches_jax(tmp_path):
    path = tmp_path / "seg_dict"
    path.write_text("hello\the@@ llo\nWorld\two@@ rld\nbad line\n",
                    encoding="utf-8")
    t, j = thw.SegDict(str(path)), jhw.SegDict(str(path))
    assert t.map == j.map
    for w in ("hello", "HELLO", "world", "other"):
        assert t.get_tokens(w) == j.get_tokens(w)


def _hw_trees(cfg_kw, seed=0):
    jcfg = jconfig.HotwordConfig(**cfg_kw)
    full = jax.tree.map(np.asarray, jhw.init(jax.random.PRNGKey(seed), jcfg))
    converted = {"embed": full["embed"], "lstm": full["lstm"]}
    return jcfg, tconfig.HotwordConfig(**cfg_kw), full, converted


@pytest.mark.parametrize("null", ["learned", "derived"])
def test_compile_hotwords_matches_jax(null):
    """[N+1, D] embeddings within EMB_ATOL; the derived null row (a
    converted checkpoint's) is the LSTM's response to a lone <s>."""
    jcfg, tcfg, full, converted = _hw_trees(
        dict(vocab_size=64, embed_dim=32, hidden_dim=32))
    tree = full if null == "learned" else converted
    model = thw.from_state_dict(params_from_jax(tree), "cpu")
    assert (model.null is None) == (null == "derived")
    words = [T(10) + T(11), "hello", T(7), "".join(T(4 + i)
                                                  for i in range(12))]
    want = jhw.compile_hotwords(tree, jcfg, words, VOCAB,
                                seg_dict=_seg_dict(jhw))
    got = thw.compile_hotwords(model, tcfg, words, TVocab(VOCAB.tokens),
                               seg_dict=_seg_dict(thw))
    assert got.shape == want.shape == (len(words) + 1, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    assert thw.compile_hotwords(model, tcfg, [], TVocab(VOCAB.tokens)) is None


def test_init_shapes():
    cfg = tconfig.HotwordConfig(vocab_size=64, embed_dim=32, hidden_dim=48)
    gen = torch.Generator().manual_seed(0)
    for null in (True, False):
        m = thw.init(cfg, gen, "cpu", learned_null=null)
        keys = set(m.state_dict())
        assert keys == {"embed.table", "lstm.wx.w", "lstm.wx.b",
                        "lstm.wh.w"} | ({"null"} if null else set())
        emb = thw.compile_hotwords(m, cfg, [T(9), T(8) + T(7)],
                                   TVocab(VOCAB.tokens))
        assert emb.shape == (3, 48) and np.isfinite(emb).all()


# -- hotword-biased pass 2 ------------------------------------------------------

HW_CFG = dict(vocab_size=64, embed_dim=32, hidden_dim=64)


@pytest.fixture(scope="module")
def hw_setup():
    """paraformer_tiny with the timestamp head and the hotword block, a
    converted hotword compiler (no null row) of the decoder's width, and
    compiled embeddings of two list sizes in two hotword-count buckets."""
    jcfg, tcfg = tiny_cfgs(timestamp=True, hotword=True)
    tree = jax_params(jcfg, 0)
    hjcfg, htcfg, _, conv = _hw_trees(HW_CFG, seed=5)
    rng = np.random.default_rng(3)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    small = [T(10) + T(11), T(30)]
    big = [T(12 + i) + T(40 + i) for i in range(12)]
    embs = [jhw.compile_hotwords(conv, hjcfg, w, VOCAB) for w in (small, big)]
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, hw_tree=conv, cmvn=cmvn,
                embs=embs)


def _speechy(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
    x *= 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
    x += 0.02 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def test_mixed_hotword_batch_matches_jax(hw_setup):
    """Segments with 3 and 13 hotword rows (buckets 4 and 16) and without
    hotwords, over two length buckets: JAX's texts and timestamps, and no
    forward mixes rows with and without hotwords."""
    s = hw_setup
    jasr = JParaformerOffline(s["tree"], s["jcfg"], VOCAB, cmvn=s["cmvn"])
    tasr = TParaformerOffline(params_from_jax(s["tree"]), s["tcfg"],
                              TVocab(VOCAB.tokens), cmvn=s["cmvn"],
                              device="cpu")
    small, big = s["embs"]
    segs = [_speechy(sec, 50 + i)
            for i, sec in enumerate((1.5, 2.0, 5.0, 1.8, 2.2, 2.6, 1.2))]
    hw_embs = [small, None, big, small, None, small, big]
    forwards = []
    fwd = tasr._forward

    def spy(feats, lens, hw_batch=None, hw_lens=None):
        forwards.append((feats.shape[1], None if hw_batch is None
                         else hw_batch.shape[1], list(hw_lens or [])))
        return fwd(feats, lens, hw_batch, hw_lens)

    tasr._forward = spy
    got = tasr.recognize_batch(segs, hw_embs=hw_embs)
    want = jasr.recognize_batch(segs, hw_embs=hw_embs)
    assert got == want and all(text for text, _ in got)
    # (length bucket, hotword bucket): (64, 4) with a batch-padding row,
    # which carries no hotwords, (64, none), (128, 16) and (64, 16)
    assert sorted(forwards, key=str) == sorted([
        (64, 4, [3, 3, 3, 0]), (64, None, []), (128, 16, [13]),
        (64, 16, [13])], key=str)
    # the embeddings reach the decoder: no hotwords, other text
    plain = tasr.recognize_batch(segs)
    assert plain != got


def _save_hotword_dir(s, path, writer):
    """A converted hotword model dir: the Paraformer's weights with the
    compiler as the top-level hotword_compiler subtree, plus a seg_dict."""
    if writer == "jax":
        jzoo.save_offline_bundle(path, dict(s["tree"],
                                            hotword_compiler=s["hw_tree"]),
                                 s["jcfg"], VOCAB.tokens, s["cmvn"])
    else:
        tzoo.save_offline_bundle(path, params_from_jax(s["tree"]), s["tcfg"],
                                 VOCAB.tokens, s["cmvn"],
                                 hotword_params=params_from_jax(s["hw_tree"]))
    with open(f"{path}/seg_dict", "w", encoding="utf-8") as f:
        f.write(f"hello\t{T(12)} {T(13)}\n")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hotword_dir_loads_through_build_models(hw_setup, tmp_path, writer):
    """The deployed model's layout: build_models loads the dir (the
    compiler kept out of the Paraformer's state dict), wires the compiler
    with HotwordConfig() and the dir's seg_dict, and serves JAX's texts
    with and without hotwords. A dir the port writes loads in JAX."""
    s = hw_setup
    path = str(tmp_path / "hw")
    _save_hotword_dir(s, path, writer)
    jb = jzoo.load_offline_bundle(path)
    assert "hotword_compiler" in jb.params
    tb = tzoo.load_offline_bundle(path)
    assert not any(k.startswith("hotword_compiler") for k in tb.params)
    assert set(tb.hotword_params) == {"embed.table", "lstm.wx.w",
                                      "lstm.wx.b", "lstm.wh.w"}
    vad_tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                                  jconfig.VadConfig()))
    tzoo.save_vad_dir(str(tmp_path / "vad"), params_from_jax(vad_tree),
                      tconfig.VadConfig())
    tm = build_models(parser().parse_args(
        ["--model-dir", path, "--vad-dir", str(tmp_path / "vad"),
         "--no-itn", "--device", "cpu"]))
    assert tm.hotword_cfg == tconfig.HotwordConfig()
    assert tm.seg_dict.get_tokens("hello") == [T(12), T(13)]
    assert tm.asr_params.decoder.hotword is not None
    jm = JServerModels(
        asr_params=jb.params, asr_cfg=jb.cfg, vocab=jb.vocab,
        asr_cmvn=jb.cmvn, vad_params=vad_tree, vad_cfg=jconfig.VadConfig(),
        hotword_params=jb.params["hotword_compiler"],
        hotword_cfg=jconfig.HotwordConfig(),
        seg_dict=jhw.SegDict(f"{path}/seg_dict"))
    hot = {T(10) + T(11): 20, "hello": 30, T(33): 20}
    want_emb = jm.compile_hotwords(hot)
    got_emb = tm.compile_hotwords(hot)
    np.testing.assert_allclose(got_emb, want_emb, rtol=0, atol=EMB_ATOL)
    wave = np.concatenate([np.zeros(8000, np.float32), _speechy(3.0, 61),
                           np.zeros(8000, np.float32)])
    for emb in (None, want_emb):
        want = jm.create_offline_recognizer().transcribe(wave, hw_emb=emb)
        got = tm.create_offline_recognizer().transcribe(wave, hw_emb=emb)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.text


def test_server_hotword_file(tmp_path):
    from asr2pass_tpu_torch.server.run_server import read_hotword_file

    path = tmp_path / "hw.txt"
    path.write_text("阿里巴巴 30\nhello world 15\nsolo\n\nbad score x\n",
                    encoding="utf-8")
    assert read_hotword_file(str(path)) == {
        "阿里巴巴": 30, "hello world": 15, "solo": 20, "bad": 20}
    demo = build_models(parser().parse_args(
        ["--demo", "--device", "cpu", "--hotword-file", str(path)]))
    assert demo.server_hotwords["阿里巴巴"] == 30
