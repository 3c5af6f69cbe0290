"""Shared set-up of the parity tests between the JAX package (the
reference) and its PyTorch port asr2pass_tpu_torch, both on the CPU.

The same tiny configuration is built in both packages, the weights come
from the JAX `init` and are carried across with
`model_zoo.params_from_jax`, and inputs are made with numpy from a seed.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.models import sanm_encoder as jenc
from asr2pass_tpu.models import sensevoice as jsv
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.models import paraformer as tparaformer
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax


def _variant(cfg, timestamp: bool, hotword: bool):
    return dataclasses.replace(
        cfg, use_hotword=hotword,
        predictor=dataclasses.replace(cfg.predictor,
                                      use_timestamp=timestamp))


def tiny_cfgs(timestamp: bool = False, hotword: bool = False):
    """(JAX config, port config) of paraformer_tiny (d=64, 2 encoder and
    2 decoder blocks), optionally with the bicif timestamp head and the
    hotword block."""
    return (_variant(jconfig.paraformer_tiny(), timestamp, hotword),
            _variant(tconfig.paraformer_tiny(), timestamp, hotword))


def jax_params(jcfg, seed: int = 0):
    """JAX parameter tree of numpy arrays."""
    params = jparaformer.init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, params)


def svs_tree(tp_blocks: int = 0, seed: int = 0):
    """JAX SenseVoice parameters (numpy) of sensevoice_tiny, with a
    tp stack of tp_blocks SAN-M layers (the converter's layout)."""
    cfg = jconfig.sensevoice_tiny()
    params = jsv.init(jax.random.PRNGKey(seed), cfg)
    if tp_blocks:
        enc = jenc.init(jax.random.PRNGKey(seed + 100), jconfig.EncoderConfig(
            input_size=64, output_size=64, num_blocks=tp_blocks + 1,
            attention_heads=2, linear_units=128))
        params["tp"] = {"rest": jax.tree.map(lambda a: a[:tp_blocks],
                                             enc["rest"]),
                        "norm": {"g": np.full(64, 1.1, np.float32),
                                 "b": np.full(64, 0.05, np.float32)}}
    return jax.tree.map(np.asarray, params)


def port_model(tree, tcfg):
    """The port's model on the CPU holding the JAX weights."""
    return tparaformer.from_state_dict(params_from_jax(tree), tcfg,
                                       device="cpu")


def t(x):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(x))


def ragged_mask(lens, t_max: int) -> np.ndarray:
    return (np.arange(t_max)[None, :]
            < np.asarray(lens)[:, None]).astype(np.float32)


def bursty(pattern, seed: int) -> np.ndarray:
    """16 kHz audio from (seconds, loud) pairs: digital silence, or a
    speech-like burst (a tone under a 4 Hz envelope, plus noise) that the
    VAD's energy gate (decibel_thres -30 dB) reads as speech."""
    rng = np.random.default_rng(seed)
    parts = []
    for sec, loud in pattern:
        n = int(sec * 16000)
        if not loud:
            parts.append(np.zeros(n, np.float32))
            continue
        tt = np.arange(n) / 16000
        x = (0.2 * np.sin(2 * np.pi * rng.uniform(120, 250) * tt)
             * 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
             + 0.02 * rng.standard_normal(n))
        parts.append(x.astype(np.float32))
    return np.concatenate(parts)


def lm_corpus(units, seed: int, n_sent: int = 40, n_words: int = 30):
    """Word sentences over `units` (token strings), made from a seed: a
    vocabulary of n_words words of 1-2 units, drawn Zipf-like."""
    rng = np.random.default_rng(seed)
    words = []
    while len(words) < n_words:
        w = "".join(units[int(k)] for k in rng.integers(0, len(units),
                                                          rng.integers(1, 3)))
        if w not in words:
            words.append(w)
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[words[int(k)] for k in rng.choice(n_words, rng.integers(2, 7),
                                               p=p)]
            for _ in range(n_sent)]


def lm_rows(vocab_size: int, n: int, seed: int, sharp: float = 3.0):
    """[n, V] log-softmax rows from a seed: each row peaks on a few
    units, so an LM has choices to make."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, vocab_size)).astype(np.float64) * sharp
    x -= np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
        + x.max(-1, keepdims=True)
    return x.astype(np.float32)


def lm_test_dirs(tmp):
    """An LM over the 64-token test vocabulary's units (lm_corpus, seed
    11, order 2), as an ARPA + lexicon dir and as TLG graph dirs (the
    per-token and the CTC topology, the port's build_tlg), with the toy
    ITN grammars of toy_itn_units; and the LM loaded by both packages."""
    from asr2pass_tpu.decode import ngram as jngram
    from asr2pass_tpu_torch.decode import ngram
    from asr2pass_tpu_torch.tools.build_tlg import build_tlg

    units = make_test_vocab(64).tokens[4:]
    sents = lm_corpus(units, 11, n_sent=60, n_words=40)
    lm = ngram.NgramLM.train(sents, order=2)
    words = sorted(w for w in lm.vocab if not w.startswith("<"))
    (tmp / "arpa").mkdir()
    lm.save_arpa(str(tmp / "arpa" / "lm.arpa"))
    (tmp / "arpa" / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(w)}\n" for w in words), encoding="utf-8")
    build_tlg(lm, {w: list(w) for w in words}, str(tmp / "tlg"))
    build_tlg(lm, {w: list(w) for w in words}, str(tmp / "ctc"),
              ctc_blank="<blank>")
    itn = toy_itn_units(tmp / "itn")
    return dict(tmp=tmp, lm=lm, words=words, arpa=str(tmp / "arpa"),
                tlg=str(tmp / "tlg"), ctc=str(tmp / "ctc"), itn=itn,
                jlm=jngram.NgramLM.load_arpa(str(tmp / "arpa" / "lm.arpa")))


LM_REWRITE = {u: str(k % 10)
              for k, u in enumerate(make_test_vocab(64).tokens[4:]) if k % 3}


def toy_itn_units(out_dir):
    """A tagger/verbalizer pair over the test vocabulary's units and the
    punctuation marks: the units of LM_REWRITE become its digits, the
    rest pass through."""
    from asr2pass_tpu_torch.decode.fst_io import FstBuilder

    units = make_test_vocab(64).tokens[4:]

    def chars(b, pairs):
        b.set_final(b.start)
        for inp, out, w in pairs:
            end = b.add_string(b.start, list(inp.encode()), list(out.encode()),
                               w)
            b.add_arc(end, 0, 0, 0.0, b.start)

    marks = "，。？、！ "
    tag = FstBuilder()
    chars(tag, [(c, f'char {{ value: "{c}" }} ', 1.0)
                for c in list(units) + list(marks)]
          + [(c, f'cardinal {{ value: "{d}" }} ', 0.5)
             for c, d in LM_REWRITE.items()])
    verb = FstBuilder()
    verb.add_arc(verb.start, ord(" "), 0, 0.0, verb.start)
    chars(verb, [(f'char {{ value: "{c}" }}', c, 0.0)
                 for c in list(units) + list(marks)]
          + [(f'cardinal {{ value: "{d}" }}', d, 0.0)
             for d in sorted(set(LM_REWRITE.values()))])
    out_dir.mkdir(parents=True, exist_ok=True)
    tag.write(str(out_dir / "zh_itn_tagger.fst"))
    verb.write(str(out_dir / "zh_itn_verbalizer.fst"))
    return str(out_dir)


def speechy(seconds: float, seed: int) -> np.ndarray:
    """A tone under a 4 Hz envelope, plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000
    x = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
    x *= 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
    x += 0.02 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def lm_trees():
    """JAX weights of the LM serving tests: paraformer_tiny with the
    timestamp head, VadConfig(), punc_tiny(300), sensevoice_tiny."""
    from asr2pass_tpu.models import ct_transformer as jct
    from asr2pass_tpu.models import fsmn_vad as jvad

    jcfg, tcfg = tiny_cfgs(timestamp=True)
    return dict(
        jcfg=jcfg, tcfg=tcfg, asr=jax_params(jcfg, 0),
        vad=jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                               jconfig.VadConfig())),
        punc=jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(2),
                                               jconfig.punc_tiny(300))),
        svs=svs_tree(0, seed=5))



# -- ONNX: the protobuf writer and the FunASR fixtures (jax-free, so that
# chip_smoke.py can use them on a machine without jax) ----------------------

from torch_onnx_fixtures import (FUNASR_ASR_YAML, FUNASR_DIMS,  # noqa: E402
                                 FUNASR_HEADS, FUNASR_SVS_YAML, FUNASR_T,
                                 FUNASR_VAD_DIMS, dnsmos_graphs,
                                 funasr_source_dirs, onnx_attr, onnx_model,
                                 onnx_node, onnx_tensor)

__all__ = ["FUNASR_ASR_YAML", "FUNASR_DIMS", "FUNASR_HEADS",
           "FUNASR_SVS_YAML", "FUNASR_T", "FUNASR_VAD_DIMS", "dnsmos_graphs",
           "funasr_source_dirs", "onnx_attr", "onnx_model", "onnx_node",
           "onnx_tensor"]
