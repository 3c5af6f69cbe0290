"""The port's slice as a whole against the JAX package on the CPU: the
Paraformer forward, the offline recognizer and whole-file transcription,
the model-directory loader and the configuration copies.

Weights come from the JAX `init` of a tiny Paraformer (d=64, 2 encoder
and 2 decoder blocks) with the bicif timestamp head and the hotword block,
carried across with `params_from_jax`.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import cif as jcif
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.runtime.offline_api import (
    OfflineRecognizer as JOfflineRecognizer)
from asr2pass_tpu.runtime.offline_asr import (
    ParaformerOffline as JParaformerOffline)
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import paraformer as tparaformer
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from asr2pass_tpu_torch.runtime.offline_api import (
    OfflineRecognizer as TOfflineRecognizer)
from asr2pass_tpu_torch.runtime.offline_asr import (
    ParaformerOffline as TParaformerOffline)
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import jax_params, port_model, ragged_mask, t, tiny_cfgs

# 2 encoder + 2 decoder blocks of width 64 and a 150-step BLSTM in fp32,
# summed in other orders than XLA's
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_cfgs(timestamp=True, hotword=True)
    tree = jax_params(jcfg, seed=0)
    return jcfg, tcfg, tree, port_model(tree, tcfg)


def _speechy(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
    x *= 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
    x += 0.02 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def test_paraformer_apply(models):
    """logits, token_num (equal), alphas, us_alphas and us_cif_peak on a
    ragged batch with a length-0 (batch-bucket padding) row, with and
    without hotword embeddings."""
    jcfg, tcfg, tree, model = models
    rng = np.random.default_rng(7)
    t_len, lens = 300, np.array([300, 170, 0])
    feats = rng.standard_normal((3, t_len, 560)).astype(np.float32)
    hw = rng.standard_normal((3, 4, 64)).astype(np.float32)
    hw_mask = ragged_mask([4, 2, 0], 4)
    max_tokens = t_len // 2 + 8
    for use_hw in (False, True):
        hw_args = (hw, hw_mask) if use_hw else (None, None)
        ref = jparaformer.apply(
            tree, jcfg, jnp.asarray(feats), jnp.asarray(lens),
            *[None if a is None else jnp.asarray(a) for a in hw_args],
            max_tokens=max_tokens)
        got = tparaformer.apply(
            model, tcfg, t(feats), torch.as_tensor(lens),
            *[None if a is None else t(a) for a in hw_args],
            max_tokens=max_tokens)
        # rounding cannot flip a fire: with the tail alpha placed as
        # fire_offline places it, no running sum of this seed comes within
        # 1e-4 of the threshold
        alphas = np.pad(np.asarray(ref.alphas), ((0, 0), (0, 1)))
        alphas[np.arange(3), lens] += jcfg.predictor.tail_threshold
        trace = np.asarray(jcif.peaks_from_alphas(jnp.asarray(alphas), 1.0))
        assert np.abs(trace - 1.0).min() > 1e-4
        np.testing.assert_array_equal(got.token_num.numpy(),
                                      np.asarray(ref.token_num))
        assert int(got.token_num[0]) > 0
        for name in ("logits", "alphas", "us_alphas", "us_cif_peak"):
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert torch.isfinite(a).all(), name
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        ids, counts = tparaformer.greedy_ids(got)
        jids, _ = jparaformer.greedy_ids(ref)
        for k, n in enumerate(counts.tolist()):
            np.testing.assert_array_equal(ids[k, :n].numpy(),
                                          np.asarray(jids)[k, :n])


@pytest.fixture(scope="module")
def recognizers(models):
    jcfg, tcfg, tree, _ = models
    vocab = make_test_vocab(jcfg.vocab_size)
    rng = np.random.default_rng(3)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    jasr = JParaformerOffline(jax_params(jcfg, 0), jcfg, vocab, cmvn=cmvn)
    tasr = TParaformerOffline(tzoo.params_from_jax(tree), tcfg,
                              TVocab(vocab.tokens), cmvn=cmvn,
                              device="cpu")
    hw = rng.standard_normal((3, 64)).astype(np.float32)
    return jasr, tasr, hw


def test_recognize_batch_matches(recognizers):
    """A mixed-length batch: three segments of the 64-frame bucket (one
    batch-bucket padding row, batch 4) and one of the 128-frame bucket;
    the same text and timestamps, with shared hotword embeddings."""
    jasr, tasr, hw = recognizers
    segs = [_speechy(s, 20 + i) for i, s in enumerate((1.5, 5.0, 2.5, 3.5))]
    ref = jasr.recognize_batch(segs, hw_emb=hw)
    got = tasr.recognize_batch(segs, hw_emb=hw)
    assert all(text for text, _ in ref)
    assert got == ref


def test_transcribe_matches(recognizers):
    """Whole-file transcription without VAD, punctuation or ITN."""
    jasr, tasr, hw = recognizers
    wave = _speechy(4.9, 30)
    ref = JOfflineRecognizer(jasr).transcribe(wave, hw)
    got = TOfflineRecognizer(tasr).transcribe(wave, hw)
    assert ref.text and ref.timestamps
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sanm_shift", [None, 0])
def test_model_dir_round_trip(models, tmp_path, sanm_shift):
    """A bundle saved by the JAX package loads in the port with identical
    arrays, configuration, vocabulary and CMVN, and a bundle the port
    saves loads in the JAX package unchanged."""
    jcfg, tcfg, tree, model = models
    jcfg = dataclasses.replace(jcfg, decoder=dataclasses.replace(
        jcfg.decoder, sanm_shift=sanm_shift))
    vocab = make_test_vocab(jcfg.vocab_size)
    cmvn = (np.linspace(-9, -7, 560).astype(np.float32),
            np.linspace(0.1, 0.5, 560).astype(np.float32))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jzoo.save_offline_bundle(jdir, tree, jcfg, vocab.tokens, cmvn)
    bundle = tzoo.load_offline_bundle(jdir)
    ref_sd = tzoo.params_from_jax(tree)
    assert bundle.params.keys() == ref_sd.keys()
    for k, v in ref_sd.items():
        assert torch.equal(bundle.params[k], v), k
    assert "encoder.rest.0.att.qkv.w" in ref_sd
    jback = jzoo.load_offline_bundle(jdir)
    assert dataclasses.asdict(bundle.cfg) == dataclasses.asdict(jback.cfg)
    assert bundle.vocab.tokens == jback.vocab.tokens
    for a, b in zip(bundle.cmvn, jback.cmvn):
        np.testing.assert_array_equal(a, b)

    tzoo.save_offline_bundle(tdir, model, bundle.cfg, vocab.tokens,
                             bundle.cmvn)
    jload = jzoo.load_offline_bundle(tdir)
    _tree_equal(jax_tree_numpy(jload.params), tree)
    assert dataclasses.asdict(jload.cfg) == dataclasses.asdict(jback.cfg)


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_params_from_jax_unstacks_layers(models):
    """Stacked [L, ...] layer axes become ModuleList entries; every other
    key is a rename."""
    jcfg, _, tree, model = models
    sd = tzoo.params_from_jax(tree)
    assert sd.keys() == model.state_dict().keys()
    w = tree["decoder"]["blocks"]["cross"]["kv"]["w"]
    for i in range(w.shape[0]):
        np.testing.assert_array_equal(
            sd[f"decoder.blocks.{i}.cross.kv.w"].numpy(), w[i])
    np.testing.assert_array_equal(sd["predictor.blstm.fw.wh.w"].numpy(),
                                  tree["predictor"]["blstm"]["fw"]["wh"]["w"])


def test_port_init_shapes_match_jax_init():
    """The port's own init gives the JAX init's shapes, and a state dict
    that round-trips through the JAX layout."""
    jcfg, tcfg = tiny_cfgs(timestamp=True, hotword=True)
    gen = torch.Generator().manual_seed(0)
    model = tparaformer.init(tcfg, gen, device="cpu")
    jtree = jax_params(jcfg)
    ttree = tzoo.params_to_jax(model)

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree).shape}

    assert shapes(ttree) == shapes(jtree)
    # the same distributions: per-tensor spread within 10 % wherever a
    # tensor has enough entries to measure it (>= 4096 draws)
    tflat, jflat = {}, {}
    tzoo._flatten(ttree, "", tflat)
    tzoo._flatten(jtree, "", jflat)
    for key, jw in jflat.items():
        if jw.size >= 4096:
            assert abs(tflat[key].std() / jw.std() - 1) < 0.1, key
            assert abs(tflat[key].mean()) < 0.1 * jw.std(), key
    # LayerNorm starts at identity, biases at zero, as in JAX
    assert torch.equal(model.encoder.after_norm.g, torch.ones(64))
    assert torch.equal(model.decoder.out.b, torch.zeros(tcfg.vocab_size))


@pytest.mark.parametrize("preset", [
    ("paraformer_large", dict(timestamp=True, hotword=True)),
    ("paraformer_large", {}),
    ("paraformer_tiny", {}),
    ("paraformer_large_online", {}),
])
def test_config_presets_are_copies(preset):
    name, kw = preset
    assert (dataclasses.asdict(getattr(tconfig, name)(**kw))
            == dataclasses.asdict(getattr(jconfig, name)(**kw)))
    if name == "paraformer_large":
        cfg = tconfig.paraformer_large(**kw)
        assert (cfg.encoder.output_size, cfg.encoder.attention_heads,
                cfg.encoder.num_blocks, cfg.decoder.num_blocks,
                cfg.encoder.linear_units, cfg.vocab_size) == \
            (512, 4, 50, 16, 2048, 8404)


def test_yaml_loader_reads_funasr_spelling(tmp_path):
    """FunASR's `sanm_shfit` (sic) key and the token_list override."""
    path = tmp_path / "config.yaml"
    path.write_text(
        "frontend_conf: {lfr_m: 7, lfr_n: 6, window: hamming}\n"
        "encoder_conf: {output_size: 256, num_blocks: 3}\n"
        "decoder_conf: {num_blocks: 2, sanm_shfit: 1}\n"
        "predictor_conf: {threshold: 1.0, tail_threshold: 0.45}\n"
        "token_list: [a, b, c]\n")
    got = tconfig.load_paraformer_yaml(str(path))
    ref = jconfig.load_paraformer_yaml(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.decoder.sanm_shift == 1 and got.vocab_size == 3
