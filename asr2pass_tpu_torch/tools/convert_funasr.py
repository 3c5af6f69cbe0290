#!/usr/bin/env python3
"""Convert FunASR PyTorch checkpoints -> model dirs both packages load.

Counterpart of the JAX package's tools/convert_funasr.py, and the
migration path for users of the reference service: take the ModelScope
model directory the reference downloads (funasr-wss-server-2pass.cpp:
195-502), its `model.pt` torch state dict or exported `model.onnx`, with
config.yaml / am.mvn / tokens.json, and write our layout
(runtime/model_zoo.py): weights.npz with '/'-joined keys and the layer
stacks stored stacked, exactly as the JAX converter writes it.

Mapping notes (torch Linear stores [out,in]; ours is [in,out], so weights
transpose; Conv1d depthwise [d,1,k] -> fsmn taps [k,d]):

  encoder.encoders0.0 / encoder.encoders.N:
    self_attn.linear_q_k_v -> encoder.{first|rest}.att.qkv
    self_attn.fsmn_block   -> ...att.fsmn.taps
    self_attn.linear_out   -> ...att.out
    feed_forward.w_1/w_2   -> ...ffn.w1/w2 ; norm1/norm2 -> ln1/ln2
  encoder.after_norm       -> encoder.after_norm
  decoder.decoders.N:
    self_attn.fsmn_block   -> decoder.blocks.fsmn.taps
    src_attn.linear_q      -> decoder.blocks.cross.q
    src_attn.linear_k_v    -> decoder.blocks.cross.kv
    src_attn.linear_out    -> decoder.blocks.cross.out
    feed_forward.w_1/w_2   -> decoder.blocks.ffn.w1/w2
    norm1/2/3              -> ln1/ln2/ln3
  decoder.decoders3.0      -> decoder.tail (ffn-only block, no residual)
  decoder.after_norm / decoder.output_layer -> after_norm / out
  predictor.cif_conv1d     -> predictor.conv ([out,in,k] -> [k,in,out])
  predictor.cif_output     -> predictor.out
  predictor.upsample_cnn   -> predictor.us_cnn (ConvTranspose1d [in,out,k]
                              -> [k,in,out]); predictor.blstm -> blstm
  predictor.cif_output2    -> predictor.us_out
  bias_encoder (LSTM)      -> hotword compiler params (model_eb role)

--verify runs the SOURCE model.onnx through tools/onnx_reader.OnnxExecutor
and the converted weights through this package's model functions
(models/sanm_encoder, cif, sanm_decoder, fsmn_vad, ct_transformer,
sensevoice), both on `device`, and raises when they disagree. Runs on the
card unless --device cpu.

CLI: python -m asr2pass_tpu_torch.tools.convert_funasr SRC DST
        [--kind auto|asr|online|vad|punc|punc_online|sensevoice]
        [--verify [--verify-tol 1e-3]] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import re
import shutil
import sys
from typing import Dict, List

import numpy as np

from asr2pass_tpu_torch.tools.transcribe import add_device_arg


def _t(w):  # torch Linear -> ours
    return np.asarray(w).T


def _a(w):
    return np.asarray(w)


def _conv_taps(w):  # depthwise Conv1d [d,1,k] -> [k,d]
    return np.asarray(w)[:, 0, :].T


def _full_conv(w):  # Conv1d [out,in,k] -> [k,in,out]
    return np.transpose(np.asarray(w), (2, 1, 0))


def _stack(layers: List[dict]):
    """Layer trees of equal structure -> one tree, each leaf stacked on a
    leading layer axis (the JAX layout of a uniform stack)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack([np.asarray(x) for x in layers])


def _att_layer(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {
        "ln1": {"g": _a(sd[f"{pfx}.norm1.weight"]),
                "b": _a(sd[f"{pfx}.norm1.bias"])},
        "att": {
            "qkv": {"w": _t(sd[f"{pfx}.self_attn.linear_q_k_v.weight"]),
                    "b": _a(sd[f"{pfx}.self_attn.linear_q_k_v.bias"])},
            "out": {"w": _t(sd[f"{pfx}.self_attn.linear_out.weight"]),
                    "b": _a(sd[f"{pfx}.self_attn.linear_out.bias"])},
            "fsmn": {"taps": _conv_taps(
                sd[f"{pfx}.self_attn.fsmn_block.weight"])},
        },
        "ln2": {"g": _a(sd[f"{pfx}.norm2.weight"]),
                "b": _a(sd[f"{pfx}.norm2.bias"])},
        "ffn": _ffn(sd, pfx),
    }


def _ffn(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {"w1": {"w": _t(sd[f"{pfx}.feed_forward.w_1.weight"]),
                   "b": _a(sd[f"{pfx}.feed_forward.w_1.bias"])},
            "w2": {"w": _t(sd[f"{pfx}.feed_forward.w_2.weight"]),
                   "b": _a(sd[f"{pfx}.feed_forward.w_2.bias"])}}


def _dec_layer(sd: Dict[str, np.ndarray], pfx: str) -> dict:
    return {
        "ln1": {"g": _a(sd[f"{pfx}.norm1.weight"]),
                "b": _a(sd[f"{pfx}.norm1.bias"])},
        "fsmn": {"taps": _conv_taps(sd[f"{pfx}.self_attn.fsmn_block.weight"])},
        "ln2": {"g": _a(sd[f"{pfx}.norm2.weight"]),
                "b": _a(sd[f"{pfx}.norm2.bias"])},
        "cross": {
            "q": {"w": _t(sd[f"{pfx}.src_attn.linear_q.weight"]),
                  "b": _a(sd[f"{pfx}.src_attn.linear_q.bias"])},
            "kv": {"w": _t(sd[f"{pfx}.src_attn.linear_k_v.weight"]),
                   "b": _a(sd[f"{pfx}.src_attn.linear_k_v.bias"])},
            "out": {"w": _t(sd[f"{pfx}.src_attn.linear_out.weight"]),
                    "b": _a(sd[f"{pfx}.src_attn.linear_out.bias"])},
        },
        "ln3": {"g": _a(sd[f"{pfx}.norm3.weight"]),
                "b": _a(sd[f"{pfx}.norm3.bias"])},
        "ffn": _ffn(sd, pfx),
    }


def _lstm_dir(sd: Dict[str, np.ndarray], pfx: str, suffix: str = "") -> dict:
    """torch nn.LSTM single direction -> our lstm params (wx [in,4H] with
    the two biases summed, wh [H,4H] without; gate order i,f,g,o as in
    torch)."""
    return {
        "wx": {"w": _t(sd[f"{pfx}.weight_ih_l0{suffix}"]),
               "b": (_a(sd[f"{pfx}.bias_ih_l0{suffix}"])
                     + _a(sd[f"{pfx}.bias_hh_l0{suffix}"]))},
        "wh": {"w": _t(sd[f"{pfx}.weight_hh_l0{suffix}"])},
    }


def _count(sd, pattern: str) -> int:
    return len({m.group(1) for k in sd if (m := re.match(pattern, k))})


def _encoder(sd, n_rest: int) -> dict:
    rest = [_att_layer(sd, f"encoder.encoders.{i}") for i in range(n_rest)]
    return {"first": _att_layer(sd, "encoder.encoders0.0"),
            "rest": _stack(rest) if rest else None,
            "after_norm": {"g": _a(sd["encoder.after_norm.weight"]),
                           "b": _a(sd["encoder.after_norm.bias"])}}


def convert_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """FunASR Paraformer state dict -> our param tree. Raises KeyError
    with the missing tensor name on layout mismatch."""
    encoder = _encoder(sd, _count(sd, r"encoder\.encoders\.(\d+)\."))
    n_dec = _count(sd, r"decoder\.decoders\.(\d+)\.")
    predictor = {
        "conv": {"w": _full_conv(sd["predictor.cif_conv1d.weight"]),
                 "b": _a(sd["predictor.cif_conv1d.bias"])},
        "out": {"w": _t(sd["predictor.cif_output.weight"]),
                "b": _a(sd["predictor.cif_output.bias"])},
    }
    if "predictor.upsample_cnn.weight" in sd:
        # CifPredictorV3 timestamp head: ConvTranspose1d [in,out,k] ->
        # [k,in,out]; BLSTM fw/bw; cif_output2 linear
        predictor["us_cnn"] = {
            "w": np.transpose(_a(sd["predictor.upsample_cnn.weight"]),
                              (2, 0, 1)),
            "b": _a(sd["predictor.upsample_cnn.bias"]),
        }
        predictor["blstm"] = {
            "fw": _lstm_dir(sd, "predictor.blstm"),
            "bw": _lstm_dir(sd, "predictor.blstm", "_reverse"),
        }
        predictor["us_out"] = {"w": _t(sd["predictor.cif_output2.weight"]),
                               "b": _a(sd["predictor.cif_output2.bias"])}
    decoder = {
        "blocks": _stack([_dec_layer(sd, f"decoder.decoders.{i}")
                          for i in range(n_dec)]),
        "after_norm": {"g": _a(sd["decoder.after_norm.weight"]),
                       "b": _a(sd["decoder.after_norm.bias"])},
        "out": {"w": _t(sd["decoder.output_layer.weight"]),
                "b": _a(sd["decoder.output_layer.bias"])},
    }
    if "decoder.decoders3.0.norm1.weight" in sd:
        pfx = "decoder.decoders3.0"
        decoder["tail"] = {"ln1": {"g": _a(sd[f"{pfx}.norm1.weight"]),
                                   "b": _a(sd[f"{pfx}.norm1.bias"])},
                           "ffn": _ffn(sd, pfx)}
    params = {
        "encoder": encoder,
        "predictor": predictor,
        "decoder": decoder,
    }
    if "bias_encoder.weight_ih_l0" in sd:
        # contextual/hotword checkpoints: the model_eb hotword compiler
        # (paraformer.cpp:592-693) = embedding + LSTM over hotword tokens
        hw = {"lstm": _lstm_dir(sd, "bias_encoder")}
        if "bias_embed.weight" in sd:
            hw["embed"] = {"table": _a(sd["bias_embed.weight"])}
        params["hotword_compiler"] = hw
    mapped_prefixes = ("encoder.", "decoder.decoders", "decoder.after_norm",
                       "decoder.output_layer", "predictor.",
                       "bias_encoder.", "bias_embed.")
    unmapped = [k for k in sd if not k.startswith(mapped_prefixes)]
    if unmapped:
        print(f"WARNING: {len(unmapped)} unmapped tensors, e.g. "
              f"{unmapped[:5]}", file=sys.stderr)
    return params


def convert_vad_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """FunASR FSMN-VAD state dict (FsmnVadStreaming: encoder=FSMN with
    in_linear1/2, fsmn.N.{0:LinearTransform,1:Fsmn,2:AffineTransform},
    out_linear1/2) -> models/fsmn_vad.py params. Depthwise Conv2d weight
    [d,1,lorder,1] -> taps [lorder,d]."""
    def lin(pfx):
        p = {"w": _t(sd[f"{pfx}.linear.weight"])}
        if f"{pfx}.linear.bias" in sd:
            p["b"] = _a(sd[f"{pfx}.linear.bias"])
        return p

    blocks = []
    for i in range(_count(sd, r"encoder\.fsmn\.(\d+)\.")):
        taps = _a(sd[f"encoder.fsmn.{i}.1.conv_left.weight"])
        blocks.append({"proj": lin(f"encoder.fsmn.{i}.0"),
                       "taps": taps[:, 0, :, 0].T,
                       "affine": lin(f"encoder.fsmn.{i}.2")})
    return {"in1": lin("encoder.in_linear1"), "in2": lin("encoder.in_linear2"),
            "blocks": blocks, "out1": lin("encoder.out_linear1"),
            "out2": lin("encoder.out_linear2")}


def convert_punc_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """FunASR CTTransformer state dict (embed + SANMEncoder + linear
    'decoder' head) -> models/ct_transformer.py params."""
    return {
        "embed": {"table": _a(sd["embed.weight"])},
        "encoder": _encoder(sd, _count(sd, r"encoder\.encoders\.(\d+)\.")),
        "out": {"w": _t(sd["decoder.weight"]), "b": _a(sd["decoder.bias"])},
    }


def convert_sensevoice_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """FunASR SenseVoiceSmall state dict -> models/sensevoice.py params.

    Layout: shared meta-query embedding table `embed.weight` (rows = lid /
    event(1) / emo(2) / textnorm ids), SenseVoiceEncoderSmall
    (encoders0/encoders/after_norm + tp_encoders/tp_norm), ctc.ctc_lo head
    — the graph the reference drives at sensevoice-small.cpp:596-642."""
    n_tp = _count(sd, r"encoder\.tp_encoders\.(\d+)\.")
    table = _a(sd["embed.weight"])
    params = {
        "encoder": _encoder(sd, _count(sd, r"encoder\.encoders\.(\d+)\.")),
        # one shared table in FunASR; our model indexes lid/tn by raw id
        # and keeps the two fixed event/emo query rows separately
        "lid_embed": table,
        "tn_embed": table,
        "query_embed": table[np.asarray([1, 2])],
        "ctc": {"w": _t(sd["ctc.ctc_lo.weight"]),
                "b": _a(sd["ctc.ctc_lo.bias"])},
    }
    if n_tp:
        params["tp"] = {
            "rest": _stack([_att_layer(sd, f"encoder.tp_encoders.{i}")
                            for i in range(n_tp)]),
            "norm": {"g": _a(sd["encoder.tp_norm.weight"]),
                     "b": _a(sd["encoder.tp_norm.bias"])},
        }
    return params


CONVERTERS = {
    "asr": convert_state_dict,
    "online": convert_state_dict,   # same module tree; split session pair
    "vad": convert_vad_state_dict,
    "punc": convert_punc_state_dict,
    # same weights as "punc"; --verify drives the 4-input VadRealtime
    # session contract instead of the 2-input offline one
    "punc_online": convert_punc_state_dict,
    "sensevoice": convert_sensevoice_state_dict,
}


# ---------------------------------------------------------------------------
# --verify: execute the SOURCE model.onnx graph as the conversion oracle
# ---------------------------------------------------------------------------

# attributes a model function may ask of a subtree that a converted tree
# need not hold: an absent bias, hotword block or tp stack reads as None
_OPTIONAL = frozenset(("b", "hotword", "tp"))


class _Params(dict):
    """A converted tree on the device, read the way the port's model
    functions read a module: subtrees by attribute or key, each stack as
    a list of layers, a dense leaf's weight as `.w` (weight_key "w")."""

    weight_key = "w"

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            if key in _OPTIONAL:
                return None
            raise AttributeError(key) from None

    @property
    def weight(self):
        return self["w"]


def device_params(params, device):
    """The converted tree (as CONVERTERS return it) as _Params on
    `device`, layer stacks unstacked through model_zoo.params_from_jax."""
    import torch

    from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax

    def nest(node):
        if isinstance(node, dict) and node and all(k.isdigit()
                                                   for k in node):
            return [nest(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return _Params({k: nest(v) for k, v in node.items()})
        return node

    root: dict = {}
    for key, val in params_from_jax(params).items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.to(device=device, dtype=torch.float32)
    tree = nest(root)
    for sub in (tree.get("encoder"), (tree.get("tp") or {})):
        if isinstance(sub, dict) and "rest" not in sub:
            sub["rest"] = []
    return tree


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def verify_against_onnx(src: str, params, kind: str, tol: float = 1e-3,
                        seed: int = 0, device="cuda") -> float:
    """Execute the source model.onnx with tools/onnx_reader.OnnxExecutor on
    random inputs and compare against the converted model's forward, both
    on `device` (the card unless "cpu").

    The oracle is the executed source graph, the same artifact the
    reference serves through ONNX Runtime (paraformer.cpp:463-589 drives
    it with [feats, feats_len] and reads [logits, token_lens]; the
    4-output timestamp layout is :549). Raises on mismatch; returns the
    max abs diff."""
    import torch

    from asr2pass_tpu_torch.tools.onnx_reader import read_onnx
    from asr2pass_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    onnx_path = os.path.join(src, "model.onnx")
    if not os.path.exists(onnx_path):
        raise FileNotFoundError(f"--verify needs {onnx_path}")
    g = read_onnx(onnx_path)
    rng = np.random.default_rng(seed)
    p = device_params(params, dev)

    with torch.inference_mode():
        if kind == "asr":
            diff = _verify_asr(src, g, p, rng, dev)
        elif kind == "punc" and any("mask" in n for n in g.inputs):
            # a VadRealtime export auto-detected as "punc": same weights,
            # but the graph takes the vad_mask/sub_masks inputs, so drive
            # the online session contract
            diff = _verify_punc_online(src, g, p, rng, dev)
        elif kind == "punc":
            diff = _verify_punc(src, g, p, rng, dev)
        elif kind == "vad":
            diff = _verify_vad(g, p, rng, dev)
        elif kind == "online":
            diff = _verify_online_pair(src, g, p, rng, dev)
        elif kind == "sensevoice":
            diff = _verify_sensevoice(src, g, p, rng, dev)
        elif kind == "punc_online":
            diff = _verify_punc_online(src, g, p, rng, dev)
        else:
            raise NotImplementedError(
                f"--verify supports kinds asr/online/vad/punc/punc_online/"
                f"sensevoice (got {kind})")
    if not diff <= tol:
        raise AssertionError(
            f"converted model disagrees with executed model.onnx: "
            f"max|diff|={diff:.2e} > {tol:g}")
    return diff


def _verify_asr(src: str, g, p, rng, dev) -> float:
    """[speech, speech_lengths] -> [logits, token_num(, us_alphas,
    us_cif_peak)] at the graph's static T (else 50 frames)."""
    import torch

    from asr2pass_tpu_torch import config as cfg_mod
    from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
    from asr2pass_tpu_torch.models.layers import length_mask
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor

    cfg = cfg_mod.load_paraformer_yaml(os.path.join(src, "config.yaml"))
    # graph input may carry a static [B, T, D]; otherwise pick T
    shape = g.input_shapes.get(g.inputs[0]) or []
    t = shape[1] if len(shape) == 3 and shape[1] else 50
    d_in = (shape[2] if len(shape) == 3 and shape[2]
            else cfg.encoder.input_size)
    feats = (rng.standard_normal((1, t, d_in)) * 0.5).astype(np.float32)
    lengths = np.asarray([t], np.int64)
    onnx_out = [_host(o) for o in OnnxExecutor(g, dev)(feats, lengths)]
    onnx_logits = onnx_out[0]
    onnx_tn = float(onnx_out[1].reshape(-1)[0])
    # drive the model stages with the GRAPH's token-count convention:
    # FunASR masks the decoder to round(sum(alphas)) tokens
    # (pre_token_length.round()), which can include one zero-pad row past
    # the last CIF fire; the serving path (paraformer.apply) uses the fire
    # count instead: equal for trained predictors, but the comparison
    # here must follow the executed graph exactly
    x = torch.from_numpy(feats).to(dev)
    lens = torch.tensor([t], device=dev)
    mask = length_mask(lens, t)
    enc = sanm_encoder.apply(p.encoder, x, mask,
                             d_model=cfg.encoder.output_size,
                             heads=cfg.encoder.attention_heads)
    alphas = cif.alphas_head(p.predictor, enc, cfg.predictor, mask)
    ac, _, _ = cif.fire_offline(enc, alphas, cfg.predictor.threshold,
                                cfg.predictor.tail_threshold, lengths=lens)
    tn = float(alphas.sum()) + cfg.predictor.tail_threshold
    u = onnx_logits.shape[1]
    if abs(u - round(tn)) > 1:
        raise AssertionError(
            f"token count mismatch: onnx U={u} (sum={onnx_tn:.2f}) vs "
            f"converted round(sum)={round(tn)} (sum={tn:.2f})")
    tok_mask = length_mask(torch.tensor([u], device=dev), ac.shape[1])
    logits = sanm_decoder.apply(p.decoder, ac, enc, enc_mask=mask,
                                mask=tok_mask, cfg=cfg.decoder)
    diff = float(np.abs(onnx_logits[0] - _host(logits)[0, :u]).max())
    if len(onnx_out) >= 4 and "us_cnn" in p.predictor:
        # 4-output timestamp layout (paraformer.cpp:549): us_alphas +
        # us_cif_peak from the bicif head, rescaled by the graph's float
        # token count (sum of alphas incl. the tail fire)
        tn_float = alphas.sum(dim=-1) + cfg.predictor.tail_threshold
        us_a = cif.upsampled_alphas(p.predictor, enc, cfg.predictor, mask,
                                    token_num=tn_float)
        us_p = cif.peaks_from_alphas(us_a, cfg.predictor.threshold - 1e-4)
        diff = max(diff, float(np.abs(onnx_out[2] - _host(us_a)).max()))
        diff = max(diff, float(np.abs(onnx_out[3] - _host(us_p)).max()))
    return diff


def _yaml_heads(src: str, default: int) -> int:
    cfg_path = os.path.join(src, "config.yaml")
    if os.path.exists(cfg_path):
        import yaml

        with open(cfg_path) as f:
            node = yaml.safe_load(f) or {}
        return (node.get("encoder_conf") or {}).get("attention_heads",
                                                    default)
    return default


def _punc_cfg(src: str, p):
    from asr2pass_tpu_torch import config as cfg_mod

    vocab, d_model = p.embed.table.shape
    return cfg_mod.PuncConfig(vocab_size=int(vocab), att_dim=int(d_model),
                              attention_heads=int(_yaml_heads(src, 8)))


def _verify_punc(src: str, g, p, rng, dev) -> float:
    """The 2-input offline contract [ids, lengths] -> [logits]."""
    import torch

    from asr2pass_tpu_torch.models import ct_transformer
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor

    cfg = _punc_cfg(src, p)
    shape = g.input_shapes.get(g.inputs[0]) or []
    t = shape[1] if len(shape) == 2 and shape[1] else 40
    ids = rng.integers(0, cfg.vocab_size, size=(1, t)).astype(np.int64)
    lengths = np.asarray([t], np.int64)
    onnx_out = OnnxExecutor(g, dev)(ids, lengths)
    onnx_logits = _host(onnx_out[0] if isinstance(onnx_out, tuple)
                        else onnx_out)
    logits = ct_transformer.apply(p, cfg, torch.from_numpy(ids).to(dev))
    return float(np.abs(onnx_logits - _host(logits)).max())


def _verify_vad(g, p, rng, dev) -> float:
    """The streaming FSMN-VAD session contract (fsmn-vad.cpp:72-135):
    [speech, in_cache_0..L-1] -> [probs, out_cache_0..L-1]. The cache
    carry ACROSS chunks is the contract under test, so three chunks are
    driven and the posteriors AND the caches compared."""
    import torch

    from asr2pass_tpu_torch.models import fsmn_vad
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor

    in_dim = p.in1.w.shape[0]
    proj = p.blocks[0].proj.w.shape[1]
    lorder = p.blocks[0].taps.shape[0]
    n_blocks = len(p.blocks)
    t = 25
    ex = OnnxExecutor(g, dev)
    caches_onnx = [np.zeros((1, proj, lorder - 1, 1), np.float32)
                   for _ in range(n_blocks)]
    caches = [torch.zeros(1, lorder - 1, proj, device=dev)
              for _ in range(n_blocks)]
    diff = 0.0
    for _ in range(3):
        feats = (rng.standard_normal((1, t, in_dim)) * 0.5).astype(np.float32)
        out = ex(feats, *caches_onnx)
        probs_o = _host(out[0])
        caches_onnx = [_host(c) for c in out[1:]]
        probs, caches = fsmn_vad.apply(p, torch.from_numpy(feats).to(dev),
                                       caches)
        diff = max(diff, float(np.abs(probs_o - _host(probs)).max()))
        for co, c in zip(caches_onnx, caches):
            diff = max(diff, float(np.abs(co[:, :, :, 0].transpose(0, 2, 1)
                                          - _host(c)).max()))
    return diff


def _run_graph(ex, candidates: dict):
    """Feed an OnnxExecutor by declared input name (torch's exporter
    prunes unused inputs like the length tensors); falls back to
    positional order when the export used other names."""
    if all(n in candidates for n in ex.g.inputs):
        return ex(*[candidates[n] for n in ex.g.inputs])
    vals = list(candidates.values())
    return ex(*vals[: len(ex.g.inputs)])


def _verify_sensevoice(src: str, g, p, rng, dev) -> float:
    """Verify the converted SenseVoice against the EXECUTED 4-input graph
    [speech, speech_lengths, language, textnorm] -> [ctc_logits] (the
    session contract sensevoice-small.cpp:596-642 drives), then run the
    reference host algorithm (CTCSearch meta-token strip + greedy
    collapse, :323-377) over the executed graph's logits and assert that
    the device greedy decode (models/sensevoice.greedy_ids) gives the
    same token ids."""
    import torch

    from asr2pass_tpu_torch import config as cfg_mod
    from asr2pass_tpu_torch.decode.ctc import ctc_greedy
    from asr2pass_tpu_torch.models import sensevoice as svs_mod
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor

    d_in = p.lid_embed.shape[1]
    d_model = p.encoder.after_norm.g.shape[0]
    cfg = cfg_mod.SenseVoiceConfig(
        encoder=cfg_mod.EncoderConfig(
            input_size=int(d_in), output_size=int(d_model),
            num_blocks=len(p.encoder.rest) + 1,
            attention_heads=int(_yaml_heads(src, 4))),
        vocab_size=int(p.ctc.w.shape[1]))
    t = 30
    feats = (rng.standard_normal((1, t, d_in)) * 0.5).astype(np.float32)
    lid_id, tn_id = cfg.lid_dict["zh"], cfg.textnorm_dict["withitn"]
    onnx_out = _run_graph(OnnxExecutor(g, dev), {
        "speech": feats, "speech_lengths": np.asarray([t], np.int32),
        "language": np.asarray([lid_id], np.int32),
        "textnorm": np.asarray([tn_id], np.int32)})
    onnx_logits = _host(onnx_out[0] if isinstance(onnx_out, tuple)
                        else onnx_out)

    def ids(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)

    out = svs_mod.apply(p, cfg, torch.from_numpy(feats).to(dev), ids(t),
                        ids(lid_id), ids(tn_id))
    diff = float(np.abs(onnx_logits - _host(out.logits)).max())
    # reference host decode over the ORACLE's logits vs the device greedy
    want, _ = ctc_greedy(onnx_logits[0], t + svs_mod.NUM_META,
                         blank_id=cfg.blank_id, skip_first=svs_mod.NUM_META)
    g_ids, counts, _ = svs_mod.greedy_ids(out, blank_id=cfg.blank_id)
    got = [int(x) for x in _host(g_ids)[0, : int(_host(counts)[0])]]
    if got != want:
        raise AssertionError(
            f"device greedy decode disagrees with the executed graph's "
            f"CTCSearch: {got} vs {want}")
    return diff


def _verify_punc_online(src: str, g, p, rng, dev) -> float:
    """Verify the converted punc model against the EXECUTED 4-input
    VadRealtime session [inputs, text_lengths, vad_mask, sub_masks] ->
    [logits] (ct-transformer-online.cpp:154-223), driving the reference
    host algorithm: the [1,1,T,T] VadMask built from the text-cache size
    is passed for BOTH mask inputs (the reference reuses the buffer), and
    the per-token punctuation argmax must match."""
    import torch

    from asr2pass_tpu_torch.models import ct_transformer
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor

    cfg = _punc_cfg(src, p)
    diff = 0.0
    ex = OnnxExecutor(g, dev)
    # text length: honor a static traced shape (torch export constant-
    # folds the posenc at the traced T); FunASR's real graphs are dynamic
    shape = g.input_shapes.get(g.inputs[0]) or []
    t0 = shape[1] if len(shape) == 2 and shape[1] else 24
    for t, cache in ((t0, 9), (t0, 0)):     # mid-stream + fresh-cache
        ids = rng.integers(0, cfg.vocab_size, size=(1, t)).astype(np.int32)
        vm = ct_transformer.vad_mask(t, cache).astype(np.float32)
        onnx_out = _run_graph(ex, {
            "inputs": ids, "text_lengths": np.asarray([t], np.int32),
            "vad_mask": vm[None, None], "sub_masks": vm[None, None]})
        onnx_logits = _host(onnx_out[0] if isinstance(onnx_out, tuple)
                            else onnx_out)
        logits = _host(ct_transformer.apply(
            p, cfg, torch.from_numpy(ids.astype(np.int64)).to(dev),
            att_mask=torch.from_numpy(vm).to(dev)))
        diff = max(diff, float(np.abs(onnx_logits - logits).max()))
        if not (np.argmax(onnx_logits[0], -1)
                == np.argmax(logits[0], -1)).all():
            raise AssertionError(
                "punctuation argmax disagrees with the executed "
                "VadRealtime graph")
    return diff


def _verify_online_pair(src: str, enc_g, p, rng, dev,
                        n_chunks: int = 3) -> float:
    """Verify the converted streaming model against the EXECUTED
    encoder/decoder ONNX pair, the pass-1 session contract
    (paraformer-online.cpp:415-523). Drives the reference's host
    algorithm: sqrt(d)-scale + absolute pos-emb (GetPosEmb :240-268),
    [cache | new] windows (AddOverlapChunk :397-413), reference-masked
    CIF search with the normalized carry row (CifSearch :270-345), and
    per-layer FSMN cache passing through decoder.onnx, comparing the
    converted encoder/alphas/decoder outputs stage by stage."""
    import torch

    from asr2pass_tpu_torch import config as cfg_mod
    from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
    from asr2pass_tpu_torch.models.layers import length_mask
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor, read_onnx

    dec_path = os.path.join(src, "decoder.onnx")
    if not os.path.exists(dec_path):
        raise FileNotFoundError(
            f"--verify kind=online needs {dec_path} (the streaming export "
            f"is an encoder/decoder session pair)")
    cfg = cfg_mod.load_paraformer_yaml(os.path.join(src, "config.yaml"))
    enc_ex = OnnxExecutor(enc_g, dev)
    dec_ex = OnnxExecutor(read_onnx(dec_path), dev)
    lookback, center, lookahead = cfg.chunk_size
    cache_len = lookback + lookahead
    d = cfg.encoder.output_size
    lfr_dim = cfg.encoder.input_size
    kernel = p.decoder.blocks[0].fsmn.taps.shape[0]
    n_dec = len(p.decoder.blocks)
    thr = cfg.predictor.threshold

    def posemb(start, length, depth):
        log_inc = math.log(10000.0) / (depth // 2 - 1)
        inv = np.exp(np.arange(depth // 2) * -log_inc)
        pos = (np.arange(start + 1, start + length + 1)[:, None]
               * inv[None, :])
        return np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)

    feats_cache = np.zeros((cache_len, lfr_dim), np.float32)
    caches_onnx = [np.zeros((1, d, kernel - 1), np.float32)
                   for _ in range(n_dec)]
    caches = torch.zeros(n_dec, 1, kernel - 1, d, device=dev)
    # CIF carry: the reference stores (integrate, frame/integrate) as a
    # pseudo alpha/hidden row prepended to the next chunk
    cif_alpha_carry, cif_hidden_carry = 0.0, np.zeros(d, np.float32)
    pos = 0
    diff = 0.0
    for ci in range(n_chunks):
        is_last = ci == n_chunks - 1
        new = (rng.standard_normal((center, lfr_dim)) * 0.5
               ).astype(np.float32)
        newp = (new * math.sqrt(d)
                + posemb(pos, center, lfr_dim)).astype(np.float32)
        pos += center
        window = np.concatenate([feats_cache, newp]).astype(np.float32)
        w = window.shape[0]
        enc_out = _run_graph(enc_ex, {
            "speech": window[None],
            "speech_lengths": np.asarray([w], np.int32)})
        enc_o, alphas_o = _host(enc_out[0]), _host(enc_out[-1])

        mask = length_mask(torch.tensor([w], device=dev), w)
        enc = sanm_encoder.apply(p.encoder,
                                 torch.from_numpy(window[None]).to(dev),
                                 mask, add_posenc=False, d_model=d,
                                 heads=cfg.encoder.attention_heads)
        alphas = cif.alphas_head(p.predictor, enc, cfg.predictor, mask)
        diff = max(diff, float(np.abs(enc_o - _host(enc)).max()))
        diff = max(diff, float(np.abs(alphas_o - _host(alphas)).max()))

        # reference alpha masking + host CIF with the carry row
        al = alphas_o[0].copy()
        al[:lookback] = 0.0
        al[lookback + center:] = 0.0
        hid = np.concatenate([cif_hidden_carry[None], enc_o[0]])
        alp = np.concatenate([[cif_alpha_carry], al])
        if is_last:
            hid = np.concatenate([hid, np.zeros((1, d), np.float32)])
            alp = np.append(alp, cfg.predictor.tail_threshold)
        fires, integ, fr = [], 0.0, np.zeros(d, np.float32)
        for a, h in zip(alp, hid):
            if integ + a < thr:
                integ += a
                fr = fr + a * h
            else:
                fires.append(fr + (thr - integ) * h)
                integ += a - thr
                fr = integ * h
        cif_alpha_carry = integ
        cif_hidden_carry = (fr / integ if integ > 0.0 else fr
                            ).astype(np.float32)

        if fires:
            embeds = np.stack(fires)[None].astype(np.float32)
            u = embeds.shape[1]
            feeds = {"enc": enc_o, "enc_len": np.asarray([w], np.int32),
                     "acoustic_embeds": embeds,
                     "acoustic_embeds_len": np.asarray([u], np.int32)}
            for li, c in enumerate(caches_onnx):
                feeds[f"in_cache_{li}"] = c
            dec_out = _run_graph(dec_ex, feeds)
            logits_o = _host(dec_out[0])
            caches_onnx = [_host(c) for c in dec_out[len(dec_out) - n_dec:]]
            logits, caches = sanm_decoder.apply_streaming(
                p.decoder, torch.from_numpy(embeds).to(dev), enc, caches,
                enc_mask=mask, heads=cfg.decoder.attention_heads)
            diff = max(diff, float(np.abs(logits_o - _host(logits)).max()))
            diff = max(diff, float(np.abs(
                np.stack(caches_onnx).transpose(0, 1, 3, 2)
                - _host(caches)).max()))
        feats_cache = window[-cache_len:]
    if not pos:
        raise AssertionError("online verify drove no chunks")
    return diff


def _guess_kind(sd: Dict[str, np.ndarray]) -> str:
    if "encoder.in_linear1.linear.weight" in sd:
        return "vad"
    if "ctc.ctc_lo.weight" in sd:
        return "sensevoice"
    if "decoder.weight" in sd and "embed.weight" in sd:
        return "punc"
    return "asr"


def read_source(src: str) -> Dict[str, np.ndarray]:
    """A FunASR dir's state dict: model.pt (torch.load, weights only) or
    the initializers of model.onnx, merged with decoder.onnx's for a
    streaming encoder/decoder pair."""
    pt = os.path.join(src, "model.pt")
    if os.path.exists(pt):
        import torch

        sd = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    # exported deployment dirs ship ONNX only; torch.onnx export keeps
    # the module-qualified parameter names as initializer names
    onnx_path = os.path.join(src, "model.onnx")
    if not os.path.exists(onnx_path):
        raise FileNotFoundError(f"neither model.pt nor model.onnx in {src}")
    from asr2pass_tpu_torch.tools.onnx_reader import read_onnx

    sd = dict(read_onnx(onnx_path).initializers)
    # streaming exports are an encoder/decoder session PAIR
    # (paraformer-online.cpp:415-523): merge the decoder graph's
    # initializers so the full module tree converts in one pass
    dec_path = os.path.join(src, "decoder.onnx")
    if os.path.exists(dec_path):
        sd.update(read_onnx(dec_path).initializers)
    # strip any export prefix and trailing const-folding suffixes
    return {k.removeprefix("onnx::").split("::")[0]: v for k, v in sd.items()}


def write_dir(src: str, dst: str, params) -> None:
    """weights.npz (runtime/model_zoo.save_params) and the source's
    config.yaml, am.mvn, tokens.json and seg_dict."""
    from asr2pass_tpu_torch.runtime.model_zoo import save_params

    os.makedirs(dst, exist_ok=True)
    save_params(os.path.join(dst, "weights.npz"), params)
    for f in ("config.yaml", "am.mvn", "tokens.json", "seg_dict"):
        path = os.path.join(src, f)
        if os.path.exists(path):
            shutil.copy(path, os.path.join(dst, f))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src", help="FunASR model dir (model.pt or model.onnx, "
                               "config.yaml, am.mvn, tokens.json)")
    p.add_argument("dst", help="output model dir")
    p.add_argument("--kind", choices=sorted(CONVERTERS) + ["auto"],
                   default="auto",
                   help="model family (default: detect from tensor names)")
    p.add_argument("--verify", action="store_true",
                   help="execute the source model.onnx (tools/onnx_reader) "
                        "on random inputs and assert the converted model "
                        "matches its outputs")
    p.add_argument("--verify-tol", type=float, default=1e-3,
                   help="max abs logit difference allowed by --verify")
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.verify:
        from asr2pass_tpu_torch.utils import resolve_device

        resolve_device(args.device)     # refuse before any work
    try:
        sd = read_source(args.src)
    except FileNotFoundError as e:
        p.error(str(e))
    kind = _guess_kind(sd) if args.kind == "auto" else args.kind
    if (kind == "asr" and args.kind == "auto"
            and os.path.exists(os.path.join(args.src, "decoder.onnx"))):
        kind = "online"
    print(f"converting as kind={kind}")
    params = CONVERTERS[kind](sd)

    if args.verify:
        diff = verify_against_onnx(args.src, params, kind,
                                   tol=args.verify_tol, device=args.device)
        print(f"verify PASSED: executed model.onnx matches converted "
              f"model, max|diff|={diff:.2e}")
    write_dir(args.src, args.dst, params)
    print(f"converted -> {args.dst}; validate with "
          f"clients/asr_client_api.check_transcripts before production")
    return 0


if __name__ == "__main__":
    sys.exit(main())
