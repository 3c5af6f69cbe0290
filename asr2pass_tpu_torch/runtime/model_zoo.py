"""Model directories: weights.npz + config.yaml + am.mvn + tokens.json.

Counterpart of the JAX package's runtime/model_zoo.py (save_params,
load_params, save_offline_bundle, load_offline_bundle, load_punc_dir,
save_svs_bundle, load_svs_bundle) and of the VAD-dir reading of the
JAX package's tools/transcribe.py. Both packages read and write the same
directories: weights.npz holds the JAX parameter tree flattened with
'/'-joined keys, with the uniform layer stacks (encoder/rest,
decoder/blocks, SenseVoice's tp/rest) stored STACKED on a leading layer
axis, and lists (the FSMN-VAD's blocks) as one key per entry. A hotword
model's weights.npz carries its hotword compiler as a top-level
`hotword_compiler` subtree beside the Paraformer's
(tools/convert_funasr.py in the JAX package writes it so).

params_from_jax / params_to_jax are the only place that knows that
layout: they map between the JAX tree and this package's state dict,
whose keys are the same names joined with '.', with each stack unstacked
into an nn.ModuleList ('encoder/rest/att/qkv/w' [L, ...] <->
'encoder.rest.<i>.att.qkv.w') and each list entry one ModuleList item
('blocks/0/taps' <-> 'blocks.0.taps'). The Paraformer and the
CT-Transformer share the encoder's stack; the VAD has none.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import yaml
from torch import nn

from asr2pass_tpu_torch import config as cfg_mod
from asr2pass_tpu_torch.frontend.audio import parse_kaldi_cmvn, write_kaldi_cmvn
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab

# JAX subtrees stored with a leading layer axis (one ModuleList here)
_STACKED = ("encoder/rest", "decoder/blocks", "tp/rest")
# the hotword compiler's subtree in a hotword model's weights.npz
HOTWORD_KEY = "hotword_compiler"


# -- nested tree <-> flat npz ----------------------------------------------

def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def _set(tree: dict, key: str, val):
    parts = key.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = val


def save_params(path: str, params: Any):
    """Nested dict/list tree of arrays (the JAX layout) -> npz."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    np.savez(path, **flat)


def _listify(node):
    """Dicts whose keys are all integers become lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def load_params(path: str) -> Any:
    """npz -> the nested tree of numpy arrays; integer keys become lists."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            _set(root, key, data[key])
    return _listify(root)


# -- JAX tree <-> state dict -----------------------------------------------

def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy arrays, as load_params rebuilds it) ->
    this package's state dict (CPU tensors)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        stem = next((s for s in _STACKED if key.startswith(s + "/")), None)
        if stem is None:
            sd[key.replace("/", ".")] = torch.from_numpy(np.array(arr))
            continue
        rest = key[len(stem) + 1:]
        for i in range(arr.shape[0]):
            name = f"{stem}/{i}/{rest}".replace("/", ".")
            sd[name] = torch.from_numpy(np.array(arr[i]))
    return sd


def params_to_jax(params: Union[nn.Module, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, Any]:
    """State dict (or module) -> the JAX tree of numpy arrays, layer
    stacks restacked, list entries back in lists. Floats are written as
    float32 (numpy has no bfloat16); other dtypes stay as they are, so a
    quantized model keeps its int8 w_q / w_q8 (a stacked `scale` is
    [L, d_out])."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, str], Dict[int, np.ndarray]] = {}
    for name, val in sd.items():
        val = val.detach().cpu()
        arr = (val.float() if val.is_floating_point() else val).numpy()
        key = name.replace(".", "/")
        stem = next((s for s in _STACKED if key.startswith(s + "/")), None)
        if stem is None:
            _set(tree, key, arr)
            continue
        idx, rest = key[len(stem) + 1:].split("/", 1)
        stacks.setdefault((stem, rest), {})[int(idx)] = arr
    for (stem, rest), layers in stacks.items():
        _set(tree, f"{stem}/{rest}",
             np.stack([layers[i] for i in range(len(layers))]))
    return _listify(tree)


# -- model bundles ----------------------------------------------------------

@dataclass
class OfflineBundle:
    params: Dict[str, torch.Tensor]     # state dict, CPU tensors
    cfg: cfg_mod.ParaformerConfig
    vocab: Vocab
    cmvn: Tuple[Optional[np.ndarray], Optional[np.ndarray]]
    # the hotword compiler's state dict (CPU tensors) when the dir holds
    # one (models/hotword.from_state_dict builds it), else None
    hotword_params: Optional[Dict[str, torch.Tensor]] = None


def save_offline_bundle(path: str, params, cfg: cfg_mod.ParaformerConfig,
                        tokens, cmvn=None, hotword_params=None):
    """Write a model directory that both packages load. `params` is a
    Paraformer module or its state dict; `hotword_params` (a Hotword
    module or its state dict) is written as the `hotword_compiler`
    subtree, as the JAX package's converter writes a hotword model."""
    os.makedirs(path, exist_ok=True)
    tree = params_to_jax(params)
    if hotword_params is not None:
        tree[HOTWORD_KEY] = params_to_jax(hotword_params)
    save_params(os.path.join(path, "weights.npz"), tree)
    with open(os.path.join(path, "tokens.json"), "w", encoding="utf-8") as f:
        json.dump(list(tokens), f, ensure_ascii=False)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        f.write(yaml.safe_dump({
            "frontend_conf": {
                "fs": cfg.frontend.fs,
                "window": cfg.frontend.window,
                "n_mels": cfg.frontend.n_mels,
                "frame_length": cfg.frontend.frame_length_ms,
                "frame_shift": cfg.frontend.frame_shift_ms,
                "lfr_m": cfg.frontend.lfr_m,
                "lfr_n": cfg.frontend.lfr_n,
            },
            "encoder_conf": {
                "output_size": cfg.encoder.output_size,
                "num_blocks": cfg.encoder.num_blocks,
                "attention_heads": cfg.encoder.attention_heads,
                "linear_units": cfg.encoder.linear_units,
                "kernel_size": cfg.encoder.kernel_size,
            },
            "decoder_conf": {
                "num_blocks": cfg.decoder.num_blocks,
                "attention_heads": cfg.decoder.attention_heads,
                "linear_units": cfg.decoder.linear_units,
                "kernel_size": cfg.decoder.kernel_size,
                # absent = in-repo causal convention; FunASR dirs always
                # carry sanm_shfit (centred window)
                **({} if cfg.decoder.sanm_shift is None
                   else {"sanm_shift": cfg.decoder.sanm_shift}),
            },
            "predictor_conf": {
                "threshold": cfg.predictor.threshold,
                "tail_threshold": cfg.predictor.tail_threshold,
                "smooth_factor": cfg.predictor.smooth_factor,
                "noise_threshold": cfg.predictor.noise_threshold,
                "use_timestamp": cfg.predictor.use_timestamp,
                "upsample_times": cfg.predictor.upsample_times,
                "smooth_factor2": cfg.predictor.smooth_factor2,
                "noise_threshold2": cfg.predictor.noise_threshold2,
            },
            "vocab_size": cfg.vocab_size,
            "lang": cfg.lang,
        }))
    if cmvn is not None and cmvn[0] is not None:
        write_kaldi_cmvn(os.path.join(path, "am.mvn"), cmvn[0], cmvn[1])


def load_offline_bundle(path: str) -> OfflineBundle:
    """Model directory -> bundle whose params are this package's state
    dict on the CPU (ParaformerOffline moves it to its device). A
    `hotword_compiler` subtree is kept out of the Paraformer's state dict
    and returned as hotword_params."""
    cfg = cfg_mod.load_paraformer_yaml(os.path.join(path, "config.yaml"))
    tree = load_params(os.path.join(path, "weights.npz"))
    hw_tree = tree.pop(HOTWORD_KEY, None)
    vocab = Vocab.from_file(os.path.join(path, "tokens.json"), cfg.lang)
    return OfflineBundle(
        params=params_from_jax(tree), cfg=cfg, vocab=vocab,
        cmvn=_dir_cmvn(path),
        hotword_params=None if hw_tree is None else params_from_jax(hw_tree))


def _dir_cmvn(path: str):
    mvn_path = os.path.join(path, "am.mvn")
    return (parse_kaldi_cmvn(mvn_path) if os.path.exists(mvn_path)
            else (None, None))


# -- FSMN-VAD and punctuation directories ----------------------------------

def save_vad_dir(path: str, params, cfg: cfg_mod.VadConfig, cmvn=None):
    """Write an FSMN-VAD model directory (weights.npz, a config.yaml that
    load_vad_yaml reads back into `cfg`, am.mvn) that both packages load.
    `params` is an FsmnVad module or its state dict."""
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "weights.npz"), params_to_jax(params))
    fe = cfg.frontend
    model_conf = {k: getattr(cfg, k) for k in (
        "detect_mode", "max_end_silence_time", "max_start_silence_time",
        "window_size_ms", "sil_to_speech_time_thres",
        "speech_to_sil_time_thres", "speech_2_noise_ratio", "do_extend",
        "lookback_time_start_point", "lookahead_time_end_point",
        "max_single_segment_time", "snr_thres",
        "noise_frame_num_used_for_snr", "decibel_thres",
        "speech_noise_thres")}
    model_conf["sil_pdf_ids"] = [int(i) for i in cfg.sil_pdf_ids]
    with open(os.path.join(path, "config.yaml"), "w") as f:
        f.write(yaml.safe_dump({
            "frontend_conf": {
                "fs": fe.fs, "window": fe.window, "n_mels": fe.n_mels,
                "frame_length": fe.frame_length_ms,
                "frame_shift": fe.frame_shift_ms,
                "lfr_m": fe.lfr_m, "lfr_n": fe.lfr_n, "dither": fe.dither,
            },
            "model_conf": model_conf,
            "encoder_conf": {
                "proj_dim": cfg.proj_dim, "linear_dim": cfg.hidden_dim,
                "output_dim": cfg.output_dim,
                "fsmn_layers": cfg.fsmn_layers, "lorder": cfg.lorder,
                "rorder": cfg.rorder,
            },
        }))
    if cmvn is not None and cmvn[0] is not None:
        write_kaldi_cmvn(os.path.join(path, "am.mvn"), cmvn[0], cmvn[1])


def load_vad_dir(path: str):
    """FSMN-VAD model directory -> (state dict on the CPU, VadConfig,
    cmvn): weights.npz, config.yaml through load_vad_yaml (VadConfig()
    when absent) and am.mvn ((None, None) when absent)."""
    vy = os.path.join(path, "config.yaml")
    cfg = (cfg_mod.load_vad_yaml(vy) if os.path.exists(vy)
           else cfg_mod.VadConfig())
    params = params_from_jax(load_params(os.path.join(path, "weights.npz")))
    mvn = os.path.join(path, "am.mvn")
    cmvn = parse_kaldi_cmvn(mvn) if os.path.exists(mvn) else (None, None)
    return params, cfg, cmvn


def save_punc_dir(path: str, params, cfg: cfg_mod.PuncConfig, tokens,
                  punc_list=None):
    """Write a punctuation model directory (weights.npz, config.yaml in
    the layout punc_cfg_from_node reads, tokens.json) that both packages
    load. `params` is a CtTransformer module or its state dict."""
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "weights.npz"), params_to_jax(params))
    with open(os.path.join(path, "tokens.json"), "w", encoding="utf-8") as f:
        json.dump(list(tokens), f, ensure_ascii=False)
    node = {
        "encoder_conf": {
            "output_size": cfg.att_dim,
            "attention_heads": cfg.attention_heads,
            "linear_units": cfg.linear_units,
            "num_blocks": cfg.num_blocks,
            "kernel_size": cfg.kernel_size,
            "sanm_shift": cfg.sanm_shift,
        },
        "vocab_size": cfg.vocab_size,
    }
    if punc_list:
        node["punc_list"] = list(punc_list)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        f.write(yaml.safe_dump(node, allow_unicode=True))


def load_punc_dir(path: str):
    """Punctuation model directory -> (state dict on the CPU,
    PuncConfig, PuncTokenizer): weights.npz, the dims and punc_list of
    config.yaml (PuncConfig() when absent) and tokens.json."""
    params = params_from_jax(load_params(os.path.join(path, "weights.npz")))
    cfg = cfg_mod.PuncConfig()
    punc_list = None
    py = os.path.join(path, "config.yaml")
    if os.path.exists(py):
        with open(py) as f:
            node = yaml.safe_load(f) or {}
        cfg = cfg_mod.punc_cfg_from_node(node)
        punc_list = node.get("punc_list")
    kw = ({"punc_list": punc_list}
          if isinstance(punc_list, list) and punc_list else {})
    tokenizer = PuncTokenizer.from_file(
        os.path.join(path, "tokens.json"), **kw)
    return params, cfg, tokenizer


# -- SenseVoice (svs) directories -------------------------------------------

@dataclass
class SvsBundle:
    params: Dict[str, torch.Tensor]     # state dict, CPU tensors
    cfg: cfg_mod.SenseVoiceConfig
    vocab: Vocab
    cmvn: Tuple[Optional[np.ndarray], Optional[np.ndarray]]


def save_svs_bundle(path: str, params, cfg: cfg_mod.SenseVoiceConfig,
                    tokens, cmvn=None):
    """Write a SenseVoice model directory (the reference's MODEL_SVS dir,
    sensevoice-small.cpp:497-560) that both packages load: weights.npz,
    tokens.json, am.mvn and the SenseVoiceConfig fields in config.yaml.
    `params` is a SenseVoice module or its state dict."""
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "weights.npz"), params_to_jax(params))
    with open(os.path.join(path, "tokens.json"), "w", encoding="utf-8") as f:
        json.dump(list(tokens), f, ensure_ascii=False)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        f.write(yaml.safe_dump({
            "model": "SenseVoiceSmall",
            "frontend_conf": {
                "fs": cfg.frontend.fs,
                "window": cfg.frontend.window,
                "n_mels": cfg.frontend.n_mels,
                "frame_length": cfg.frontend.frame_length_ms,
                "frame_shift": cfg.frontend.frame_shift_ms,
                "lfr_m": cfg.frontend.lfr_m,
                "lfr_n": cfg.frontend.lfr_n,
            },
            "encoder_conf": {
                "output_size": cfg.encoder.output_size,
                "num_blocks": cfg.encoder.num_blocks,
                "attention_heads": cfg.encoder.attention_heads,
                "linear_units": cfg.encoder.linear_units,
                "kernel_size": cfg.encoder.kernel_size,
            },
            "vocab_size": cfg.vocab_size,
            "blank_id": cfg.blank_id,
            "lid_pairs": [list(p) for p in cfg.lid_pairs],
            "textnorm_pairs": [list(p) for p in cfg.textnorm_pairs],
            "lang": cfg.lang,
        }))
    if cmvn is not None and cmvn[0] is not None:
        write_kaldi_cmvn(os.path.join(path, "am.mvn"), cmvn[0], cmvn[1])


def load_svs_bundle(path: str) -> SvsBundle:
    """SenseVoice model directory -> bundle whose params are this
    package's state dict on the CPU; the vocab size follows tokens.json."""
    cfg = cfg_mod.load_svs_yaml(os.path.join(path, "config.yaml"))
    params = params_from_jax(load_params(os.path.join(path, "weights.npz")))
    with open(os.path.join(path, "tokens.json"), encoding="utf-8") as f:
        tokens = json.load(f)
    if len(tokens) != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=len(tokens))
    return SvsBundle(params=params, cfg=cfg, vocab=Vocab(tokens, cfg.lang),
                     cmvn=_dir_cmvn(path))
