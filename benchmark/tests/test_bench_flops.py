"""The FLOP formulas against torch.utils.flop_counter on the plain
reference at a small width, from the same true lengths."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.families import common
from benchmark.lib import flops, weights
from benchmark.reference import config as rc
from benchmark.reference import nets


def counted(fn) -> int:
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def small_paraformer(timestamp: bool):
    return rc.ParaformerConfig(
        encoder=rc.EncoderConfig(output_size=32, num_blocks=3,
                                 attention_heads=2, linear_units=48),
        decoder=rc.DecoderConfig(num_blocks=2, attention_heads=2,
                                 linear_units=40),
        predictor=rc.PredictorConfig(idim=32, use_timestamp=timestamp),
        vocab_size=50)


@pytest.mark.parametrize("timestamp", [False, True])
@pytest.mark.parametrize("t", [7, 23])
def test_paraformer(timestamp, t):
    cfg = small_paraformer(timestamp)
    sd = weights.make(weights.paraformer(cfg), 1, "asr", "cpu")
    feats = torch.randn(t, 560)
    out = {}
    got = counted(lambda: out.setdefault("o", nets.paraformer(sd, cfg,
                                                               feats)))
    u = out["o"].logits.shape[0]
    assert got == flops.paraformer(cfg, t, u)


@pytest.mark.parametrize("t", [5, 19])
def test_sensevoice(t):
    cfg = rc.SenseVoiceConfig(
        encoder=rc.EncoderConfig(output_size=32, num_blocks=3,
                                 attention_heads=2, linear_units=48),
        vocab_size=70)
    sd = weights.make(weights.sensevoice(cfg, 2), 1, "asr", "cpu")
    got = counted(lambda: nets.sensevoice(sd, cfg, torch.randn(t, 560), 0,
                                          14))
    assert got == flops.sensevoice(cfg, t, 2)


@pytest.mark.parametrize("n", [1, 31])
def test_fsmn_vad(n):
    cfg = rc.VadConfig()
    sd = weights.make(weights.fsmn_vad(cfg), 1, "vad", "cpu")
    got = counted(lambda: nets.fsmn_vad(sd, torch.randn(n, 400)))
    assert got == flops.fsmn_vad(cfg, n)


@pytest.mark.parametrize("n", [3, 20])
def test_ct_transformer(n):
    cfg = dataclasses.replace(rc.PuncConfig(), vocab_size=90, embed_dim=16,
                              att_dim=16, num_blocks=2, attention_heads=2,
                              linear_units=24)
    enc = common.punc_encoder(rc, cfg)
    sd = weights.make(weights.ct_transformer(cfg, enc), 1, "punc", "cpu")
    got = counted(lambda: nets.ct_transformer(sd, cfg, list(range(n))))
    assert got == flops.ct_transformer(cfg, enc, n)
