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
