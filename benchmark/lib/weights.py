"""Seeded weights for a whole model in a few large calls on the device.

A spec maps each state-dict key to (shape, init): ("uniform", a) draws
U(-a, a), ("normal", s) draws N(0, s^2), ("ones",) and ("zeros",) fill.
All uniform leaves are views of one torch.rand buffer and all normal
leaves of one torch.randn buffer, drawn from a generator on the device
seeded from the run's seed and the model's name, so the same seed gives
the same weights to the program and, after the program is gone, to the
reference.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[tuple, tuple]]


def generator(seed: int, name: str, device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return g


def make(spec: Spec, seed: int, name: str, device) -> Dict[str, torch.Tensor]:
    """The state dict of `spec`, float32 on `device`."""
    g = generator(seed, name, device)
    sizes = {"uniform": 0, "normal": 0}
    for shape, init in spec.values():
        if init[0] in sizes:
            sizes[init[0]] += math.prod(shape)
    pools = {
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device),
        "normal": torch.randn(sizes["normal"], generator=g, device=device),
    }
    at = {"uniform": 0, "normal": 0}
    sd = {}
    for key, (shape, init) in spec.items():
        kind = init[0]
        if kind == "ones":
            sd[key] = torch.ones(shape, device=device)
        elif kind == "zeros":
            sd[key] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            x = pools[kind][at[kind]: at[kind] + n].view(shape)
            at[kind] += n
            sd[key] = ((x * 2 - 1) * init[1] if kind == "uniform"
                       else x * init[1])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return sd


# -- the models' parameter layouts (the program's state-dict keys) ----------

def dense(spec: Spec, key: str, d_in: int, d_out: int, bias: bool = True):
    spec[f"{key}.w"] = ((d_in, d_out), ("uniform", 1 / math.sqrt(d_in)))
    if bias:
        spec[f"{key}.b"] = ((d_out,), ("zeros",))


def norm(spec: Spec, key: str, d: int):
    spec[f"{key}.g"] = ((d,), ("ones",))
    spec[f"{key}.b"] = ((d,), ("zeros",))


def sanm_layer(spec: Spec, key: str, d_in: int, enc):
    d = enc.output_size
    norm(spec, f"{key}.ln1", d_in)
    dense(spec, f"{key}.att.qkv", d_in, 3 * d)
    dense(spec, f"{key}.att.out", d, d)
    taps = ("uniform", 1 / math.sqrt(enc.kernel_size))
    spec[f"{key}.att.fsmn.taps"] = ((enc.kernel_size, d), taps)
    norm(spec, f"{key}.ln2", d)
    dense(spec, f"{key}.ffn.w1", d, enc.linear_units)
    dense(spec, f"{key}.ffn.w2", enc.linear_units, d)


def encoder(spec: Spec, key: str, enc):
    sanm_layer(spec, f"{key}.first", enc.input_size, enc)
    for i in range(1, enc.num_blocks):
        sanm_layer(spec, f"{key}.rest.{i - 1}", enc.output_size, enc)
    norm(spec, f"{key}.after_norm", enc.output_size)


def cross(spec: Spec, key: str, d: int):
    dense(spec, f"{key}.q", d, d)
    dense(spec, f"{key}.kv", d, 2 * d)
    dense(spec, f"{key}.out", d, d)


def paraformer(cfg) -> Spec:
    """cfg: a ParaformerConfig (the hotword block when cfg.use_hotword)."""
    spec: Spec = {}
    encoder(spec, "encoder", cfg.encoder)
    p, d = cfg.predictor, cfg.encoder.output_size
    kernel = p.l_order + p.r_order + 1
    spec["predictor.conv.w"] = ((kernel, p.idim, p.idim),
                                ("normal", 1 / math.sqrt(kernel * p.idim)))
    spec["predictor.conv.b"] = ((p.idim,), ("zeros",))
    dense(spec, "predictor.out", p.idim, 1)
    if p.use_timestamp:
        spec["predictor.us_cnn.w"] = ((p.upsample_times, p.idim, p.idim),
                                      ("normal", 1 / math.sqrt(p.idim)))
        spec["predictor.us_cnn.b"] = ((p.idim,), ("zeros",))
        half = p.idim // 2
        for side in ("fw", "bw"):
            dense(spec, f"predictor.blstm.{side}.wx", p.idim, 4 * half)
            dense(spec, f"predictor.blstm.{side}.wh", half, 4 * half,
                  bias=False)
        dense(spec, "predictor.us_out", p.idim, 1)
    dec = cfg.decoder
    for i in range(dec.num_blocks):
        k = f"decoder.blocks.{i}"
        norm(spec, f"{k}.ln1", d)
        dense(spec, f"{k}.ffn.w1", d, dec.linear_units)
        dense(spec, f"{k}.ffn.w2", dec.linear_units, d)
        norm(spec, f"{k}.ln2", d)
        spec[f"{k}.fsmn.taps"] = ((dec.kernel_size, d),
                                  ("uniform", 1 / math.sqrt(dec.kernel_size)))
        norm(spec, f"{k}.ln3", d)
        cross(spec, f"{k}.cross", d)
    norm(spec, "decoder.tail.ln1", d)
    dense(spec, "decoder.tail.ffn.w1", d, dec.linear_units)
    dense(spec, "decoder.tail.ffn.w2", dec.linear_units, d)
    norm(spec, "decoder.after_norm", d)
    dense(spec, "decoder.out", d, cfg.vocab_size)
    if cfg.use_hotword:
        norm(spec, "decoder.hotword.ln", d)
        cross(spec, "decoder.hotword.cross", d)
    return spec


def sensevoice(cfg, tp_blocks: int) -> Spec:
    spec: Spec = {}
    enc = cfg.encoder
    encoder(spec, "encoder", enc)
    n_lid = max(dict(cfg.lid_pairs).values()) + 1
    n_tn = max(dict(cfg.textnorm_pairs).values()) + 1
    spec["lid_embed"] = ((n_lid, enc.input_size), ("normal", 0.02))
    spec["tn_embed"] = ((n_tn, enc.input_size), ("normal", 0.02))
    spec["query_embed"] = ((2, enc.input_size), ("normal", 0.02))
    dense(spec, "ctc", enc.output_size, cfg.vocab_size)
    for i in range(tp_blocks):
        sanm_layer(spec, f"tp.rest.{i}", enc.output_size, enc)
    if tp_blocks:
        norm(spec, "tp.norm", enc.output_size)
    return spec


def fsmn_vad(cfg) -> Spec:
    spec: Spec = {}
    dense(spec, "in1", cfg.input_dim, 140)
    dense(spec, "in2", 140, cfg.hidden_dim)
    dense(spec, "out1", cfg.hidden_dim, 140)
    dense(spec, "out2", 140, cfg.output_dim)
    for i in range(cfg.fsmn_layers):
        dense(spec, f"blocks.{i}.proj", cfg.hidden_dim, cfg.proj_dim,
              bias=False)
        spec[f"blocks.{i}.taps"] = ((cfg.lorder, cfg.proj_dim),
                                    ("normal", 1 / math.sqrt(cfg.lorder)))
        dense(spec, f"blocks.{i}.affine", cfg.proj_dim, cfg.hidden_dim)
    return spec


def ct_transformer(cfg, enc) -> Spec:
    """cfg: a PuncConfig; enc: its encoder as an EncoderConfig."""
    spec: Spec = {"embed.table": ((cfg.vocab_size, cfg.embed_dim),
                                  ("normal", 0.02))}
    encoder(spec, "encoder", enc)
    dense(spec, "out", cfg.att_dim, cfg.num_classes)
    return spec
