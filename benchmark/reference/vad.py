"""Offline VAD segmentation, plain: 1 s windows through the streaming
front-end, the FSMN-VAD net (causal, so run once over all rows), and the
decision automaton fed window by window, its open/close events joined
into closed [start_ms, end_ms] segments.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.e2e_vad import E2EVadStateMachine, VadOptions
from benchmark.reference.frontend import StreamingFrontend


def options(cfg) -> VadOptions:
    names = ("sample_rate", "max_end_silence_time", "max_start_silence_time",
             "window_size_ms", "sil_to_speech_time_thres",
             "speech_to_sil_time_thres", "speech_2_noise_ratio", "do_extend",
             "lookback_time_start_point", "lookahead_time_end_point",
             "max_single_segment_time", "snr_thres", "decibel_thres",
             "speech_noise_thres", "frame_in_ms", "frame_length_ms")
    kw = {k: getattr(cfg, k) for k in names}
    return VadOptions(sil_pdf_ids=tuple(cfg.sil_pdf_ids), **kw)


@torch.inference_mode()
def segments(sd: Dict[str, torch.Tensor], cfg, samples: np.ndarray, cmvn,
             max_end_sil: int, max_single_segment: int, device,
             window_s: float = 1.0) -> List[List[int]]:
    fe = StreamingFrontend(cfg.frontend, cmvn[0], cmvn[1], device=device)
    step = int(cfg.sample_rate * window_s)
    chunks = []
    for off in range(0, len(samples), step):
        part = samples[off: off + step]
        final = off + step >= len(samples)
        chunks.append((part, fe.accept(part, final), final))
    rows = np.concatenate([c[1] for c in chunks]) if chunks else None
    probs = (nets.fsmn_vad(sd, torch.as_tensor(rows, device=device)
                           ).cpu().numpy() if rows is not None and len(rows)
             else np.zeros((0, cfg.output_dim), np.float32))
    sm = E2EVadStateMachine(options(cfg))
    events, at = [], 0
    for part, feats, final in chunks:
        p = probs[at: at + len(feats)]
        at += len(feats)
        if len(p) == 0 and not final:
            continue
        events.extend(sm(p, part, is_final=final, online=True,
                         max_end_sil=max_end_sil,
                         max_single_segment_time=max_single_segment,
                         speech_noise_thres=cfg.speech_noise_thres))
    out, start = [], -1
    for s, e in events:
        if s != -1:
            start = s
        if e != -1 and start != -1:
            out.append([start, e])
            start = -1
    return out
