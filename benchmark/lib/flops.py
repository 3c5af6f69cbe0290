"""Model FLOPs from true lengths: 2 x multiply-adds of every matrix
product and attention product of one utterance's forward, as the plain
reference computes it (no padding, no bucket). Elementwise work (the FSMN
memories, norms, activations, the CIF and LSTM cell updates) is not
counted, as torch.utils.flop_counter does not count it; the CPU tests hold
these formulas to that counter on the reference at a tiny width.
"""
from __future__ import annotations

FRAME_LENGTH, FRAME_SHIFT = 400, 160   # 25 ms and 10 ms at 16 kHz


def num_frames(n_samples: int) -> int:
    if n_samples < FRAME_LENGTH:
        return 0
    return 1 + (n_samples - FRAME_LENGTH) // FRAME_SHIFT


def encoder(enc, t: int) -> float:
    """The SAN-M encoder over t positions."""
    d, u = enc.output_size, enc.linear_units

    def block(d_in):
        return (2 * t * d_in * 3 * d      # qkv
                + 4 * t * t * d           # scores and context
                + 2 * t * d * d           # out
                + 4 * t * d * u)          # feed-forward

    return block(enc.input_size) + (enc.num_blocks - 1) * block(d)


def paraformer(cfg, t: int, u: int) -> float:
    """t LFR frames, u tokens fired."""
    if t == 0:
        return 0.0
    p, dec = cfg.predictor, cfg.decoder
    d = cfg.encoder.output_size
    kernel = p.l_order + p.r_order + 1
    total = encoder(cfg.encoder, t)
    total += 2 * t * p.idim * p.idim * kernel + 2 * t * p.idim   # alphas
    if p.use_timestamp:
        up, half = p.upsample_times, p.idim // 2
        total += 2 * t * p.idim * p.idim * kernel                # conv
        total += 2 * t * p.idim * up * p.idim                    # upsample
        total += 2 * (2 * up * t * p.idim * 4 * half             # inputs
                      + 2 * up * t * half * 4 * half)            # recurrence
        total += 2 * up * t * p.idim                             # us_out
    per_block = (4 * u * d * dec.linear_units                    # ffn
                 + 2 * u * d * d + 2 * t * d * 2 * d             # q, kv
                 + 4 * u * t * d + 2 * u * d * d)                # att, out
    total += dec.num_blocks * per_block
    total += 4 * u * d * dec.linear_units + 2 * u * d * cfg.vocab_size
    return float(total)


def sensevoice(cfg, t: int, tp_blocks: int) -> float:
    """t LFR frames (the 4 meta positions are added)."""
    if t == 0:
        return 0.0
    n = t + 4
    enc = cfg.encoder
    d, u = enc.output_size, enc.linear_units
    tp = tp_blocks * (2 * n * d * 3 * d + 4 * n * n * d + 2 * n * d * d
                      + 4 * n * d * u)
    return float(encoder(enc, n) + tp + 2 * n * d * cfg.vocab_size)


def fsmn_vad(vcfg, n: int) -> float:
    """n feature rows through the VAD net."""
    h, pr = vcfg.hidden_dim, vcfg.proj_dim
    per = (vcfg.input_dim * 140 + 140 * h + h * 140 + 140 * vcfg.output_dim
           + vcfg.fsmn_layers * (h * pr + pr * h))
    return float(2 * n * per)


def ct_transformer(pcfg, enc, n: int) -> float:
    """One punctuation window of n words."""
    if n == 0:
        return 0.0
    return float(encoder(enc, n) + 2 * n * pcfg.att_dim * pcfg.num_classes)
