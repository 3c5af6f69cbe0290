"""What the offline families share: the configuration file read into both
the program's and the reference's dataclasses, the VAD and punctuation
models, the vocabularies, the hooks that record what the timed path
served, and the checks of the VAD and the text.

A family module (paraformer.py, sensevoice.py) adds its recognizer, its
comparison of the served tokens with the plain network, and its FLOPs.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import flops, weights
from benchmark.reference import config as ref_config
from benchmark.reference import nets, text
from benchmark.reference import vad as ref_vad

FS = 16000


def frontend(mod, node: dict):
    return mod.FrontendConfig(**node)


def encoder_cfg(mod, node: dict):
    return mod.EncoderConfig(**node)


def vad_cfg(mod, node: dict):
    """node: the configuration file's "vad" (its model under "config")."""
    kw = {k: v for k, v in node["config"].items() if k != "frontend"}
    kw["sil_pdf_ids"] = tuple(kw.get("sil_pdf_ids", (0,)))
    return mod.VadConfig(frontend=frontend(mod, node["config"]["frontend"]),
                         **kw)


def punc_cfg(mod, node: dict):
    return mod.PuncConfig(**node)


def punc_encoder(mod, pcfg):
    return mod.EncoderConfig(input_size=pcfg.embed_dim,
                             output_size=pcfg.att_dim,
                             num_blocks=pcfg.num_blocks,
                             attention_heads=pcfg.attention_heads,
                             linear_units=pcfg.linear_units,
                             kernel_size=pcfg.kernel_size)


def asr_tokens(vocab_size: int) -> List[str]:
    """Specials, then one CJK character a token."""
    return ["<blank>", "<s>", "</s>", "<unk>"] + [
        chr(0x4E00 + i) for i in range(vocab_size - 4)]


def punc_tokens(vocab_size: int, asr: List[str]) -> List[str]:
    out = ["<blank>", "<unk>"] + asr[4:]
    return out + [f"w{i}" for i in range(vocab_size - len(out))]


def cmvn(pair, dim: int):
    return (np.full(dim, pair[0], np.float32),
            np.full(dim, pair[1], np.float32))


def vad_weights(node: dict, vcfg, seed: int, device):
    sd = weights.make(weights.fsmn_vad(vcfg), seed, "vad", device)
    # the silence pdf's bias (an assumed value of the configuration): with
    # random weights the net then never calls a frame silence, and the
    # decibel gate alone segments, as it does on the energy of real speech
    sd["out2.b"][list(vcfg.sil_pdf_ids)] = node["vad"]["sil_bias"]
    return sd


def punc_weights(pcfg, seed: int, device):
    enc = punc_encoder(ref_config, pcfg)
    return weights.make(weights.ct_transformer(pcfg, enc), seed, "punc",
                        device)


class Served:
    """What the timed path served for one file: the transcribe result and,
    recorded by hooks on the recognizer and the punctuator, each
    segment's host arrays and each punctuation window."""

    def __init__(self, samples: np.ndarray):
        self.samples = samples
        self.seconds = len(samples) / FS
        self.result = None
        self.segments: Dict[int, dict] = {}
        self.windows: List[tuple] = []


class Recorder:
    """Hooks on the program's objects. `current` is the file being served;
    finish_batch's fetched arrays and the punctuator's window decisions
    are copied into it."""

    def __init__(self):
        self.current: Optional[Served] = None

    def on_finish(self, unpack):
        """unpack(pending, fetched) -> {segment index: dict}: the family's
        reading of finish_batch's host arrays."""
        def around(fn):
            def call(pending, fetched, *a, **kw):
                if self.current is not None:
                    self.current.segments.update(unpack(pending, fetched))
                return fn(pending, fetched, *a, **kw)
            return call
        return around

    def on_infer(self, fn):
        def call(ids, cache_size=0):
            out = fn(ids, cache_size)
            if self.current is not None:
                self.current.windows.append((list(ids), cache_size,
                                             list(out)))
            return out
        return call


# host seconds spent inside each range since the harness last cleared it
STAGE_S: Dict[str, float] = {}


def ranged(name: str, fn):
    """fn inside a profiler range `name` (a no-op when nothing traces),
    its host seconds added to STAGE_S[name]."""
    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        finally:
            STAGE_S[name] = STAGE_S.get(name, 0.0) + time.perf_counter() - t0
    return call


# -- checks ----------------------------------------------------------------

class Readings:
    """The compared numbers of one run, each the worst over the sample."""

    def __init__(self):
        self.values: Dict[str, float] = {}

    def worst(self, name: str, value: float):
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    def add(self, name: str, value: float):
        self.values[name] = self.values.get(name, 0.0) + float(value)

    def least(self, name: str, value: float):
        self.values[name] = min(self.values.get(name, math.inf),
                                float(value))


def check_vad(served: Served, sd_vad, vcfg, vad_node, device) -> List[list]:
    """The plain VAD's segments of the file, with the recognizer's
    end-silence and longest-segment settings."""
    return ref_vad.segments(sd_vad, vcfg, served.samples,
                            cmvn(vad_node["cmvn"], vcfg.input_dim),
                            max_end_sil=vad_node["max_end_sil"],
                            max_single_segment=vad_node["max_single_segment"],
                            device=device)


def check_punc(served: Served, sd_punc, pcfg, asr_text: str,
             tok2id: dict, read: Readings):
    """The punctuation stage, followed from the served window decisions:
    each window's words must be those the loop builds from the served
    text and the decisions before it; each served class is read under the
    plain network's logits (its gap below the best class joins the
    tokens' in `argmax_gap`). Returns the text assembled from the served
    words and classes, which the served text must equal."""
    tokens, ids = text.tokenize(asr_text, tok2id)
    if not tokens:
        return asr_text
    decided = served.windows
    mismatch = [0]

    def decide(bi, w_ids):
        if bi >= len(decided) or decided[bi][0] != list(w_ids):
            mismatch[0] += 1
            return [text.NOTPUNC] * len(w_ids)
        return decided[bi][2]

    words, classes, wins = text.punc_windows(
        tokens, ids, pcfg.token_len, pcfg.cache_pop_trigger_limit, decide)
    read.worst("punc_window_off", mismatch[0] + abs(len(wins) - len(decided)))
    with torch.inference_mode():
        for w_ids, _cache, served_cls in decided[: len(wins)]:
            logits = nets.ct_transformer(sd_punc, pcfg, w_ids).float()
            got = logits.gather(-1, torch.tensor(
                served_cls, device=logits.device)[:, None])[:, 0]
            read.worst("argmax_gap",
                       float((logits.max(-1).values - got).max()))
    return text.punctuated(words, classes)


def punc_control(sd_punc, pcfg, asr_text: str, tok2id: dict,
                 read: Readings):
    """The punctuation stage with the network in TF32 in the program's
    place, read as check_punc reads served decisions."""
    tokens, ids = text.tokenize(asr_text, tok2id)
    if not tokens:
        return
    ctl = Served(np.zeros(0, np.float32))

    def decide(_bi, w_ids):
        with torch.inference_mode(), tf32():
            cls = nets.ct_transformer(sd_punc, pcfg, w_ids).argmax(-1)
        ctl.windows.append((list(w_ids), 0, cls.tolist()))
        return cls.tolist()

    text.punc_windows(tokens, ids, pcfg.token_len,
                      pcfg.cache_pop_trigger_limit, decide)
    check_punc(ctl, sd_punc, pcfg, asr_text, tok2id, read)


def vad_punc_flops(served: Served, vcfg, pcfg) -> float:
    """The VAD net over the file and each punctuation window (pcfg None:
    no punctuation model)."""
    total = flops.fsmn_vad(vcfg, flops.num_frames(len(served.samples)))
    if pcfg is not None:
        enc = punc_encoder(ref_config, pcfg)
        for w_ids, _c, _p in served.windows:
            total += flops.ct_transformer(pcfg, enc, len(w_ids))
    return total


class tf32:
    """TF32 products inside the block (the control's precision)."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
