"""Per-stream VAD: streaming front-end -> FSMN net -> decision automaton.

Counterpart of the JAX package's runtime/vad_stream.py. The net runs on the
device over chunks padded to 25-frame buckets with its caches there; the
posteriors come back to the host once a chunk for the automaton. The
offline variant streams 1 s windows through the same path and joins the
events into closed segments.

Spans (runtime/metrics): vad.setup (the stream's construction in
vad_segments_offline), vad.frontend, vad.net and vad.automaton (one
each a chunk), and vad.fetch around each of the chunk's two blocking
copies to the host (the front-end's mel rows, the net's posteriors).
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import VadConfig
from asr2pass_tpu_torch.models import fsmn_vad
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from asr2pass_tpu_torch.utils import fp32_products, resolve_device
from asr2pass_tpu_torch.vad.e2e_vad import E2EVadStateMachine, VadOptions

_BUCKET = 25


def vad_options(cfg: VadConfig, sil_pdf_ids=None) -> VadOptions:
    """The decision automaton's options from a VAD config (its
    model_conf). sil_pdf_ids overrides the config's: the engine hands the
    automaton one column, the silence posterior already summed on the
    device, so it passes (0,)."""
    return VadOptions(
        sample_rate=cfg.sample_rate,
        max_end_silence_time=cfg.max_end_silence_time,
        max_start_silence_time=cfg.max_start_silence_time,
        window_size_ms=cfg.window_size_ms,
        sil_to_speech_time_thres=cfg.sil_to_speech_time_thres,
        speech_to_sil_time_thres=cfg.speech_to_sil_time_thres,
        speech_2_noise_ratio=cfg.speech_2_noise_ratio,
        do_extend=cfg.do_extend,
        lookback_time_start_point=cfg.lookback_time_start_point,
        lookahead_time_end_point=cfg.lookahead_time_end_point,
        max_single_segment_time=cfg.max_single_segment_time,
        snr_thres=cfg.snr_thres,
        decibel_thres=cfg.decibel_thres,
        speech_noise_thres=cfg.speech_noise_thres,
        sil_pdf_ids=tuple(cfg.sil_pdf_ids if sil_pdf_ids is None
                          else sil_pdf_ids),
        frame_in_ms=cfg.frame_in_ms,
        frame_length_ms=cfg.frame_length_ms,
    )


class FsmnVadStream:
    """One stream's VAD state; `accept` returns the newly decided
    segments in ms ([s,e] / [s,-1] / [-1,e] online). params: an FsmnVad
    module or its state dict, run on `device` (default the card)."""

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: VadConfig, cmvn=None, online: bool = True,
                 max_end_sil: Optional[int] = None,
                 max_single_segment: Optional[int] = None,
                 speech_noise_thres: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.params = params.to(self.device).eval().requires_grad_(False)
        else:
            self.params = fsmn_vad.from_state_dict(params, cfg, self.device)
        self.cfg = cfg
        self.online = online
        means, vars_ = (cmvn if cmvn is not None else (None, None))
        self.frontend = StreamingFrontend(cfg.frontend, means, vars_,
                                          device=self.device,
                                          fetch_span="vad.fetch")
        self.caches = fsmn_vad.init_caches(cfg, 1, self.device)
        self.sm = E2EVadStateMachine(vad_options(cfg))
        self.max_end_sil = (max_end_sil if max_end_sil is not None
                            else cfg.max_end_silence_time)
        self.max_single_segment = (max_single_segment
                                   if max_single_segment is not None
                                   else cfg.max_single_segment_time)
        self.speech_noise_thres = (speech_noise_thres
                                   if speech_noise_thres is not None
                                   else cfg.speech_noise_thres)

    def set_config(self, max_end_sil: Optional[int] = None,
                   max_single_segment: Optional[int] = None):
        """Per-request overrides (vad_tail_sil / vad_max_len)."""
        if max_end_sil is not None:
            self.max_end_sil = max_end_sil
        if max_single_segment is not None:
            self.max_single_segment = max_single_segment

    def reset(self):
        self.frontend.reset()
        self.caches = fsmn_vad.init_caches(self.cfg, 1, self.device)
        self.sm._all_reset()

    @torch.inference_mode()
    def _nn_step(self, feats: np.ndarray) -> np.ndarray:
        with METRICS.stage("vad.net"):
            t = feats.shape[0]
            bucket = -(-t // _BUCKET) * _BUCKET
            padded = np.zeros((1, bucket, feats.shape[1]), np.float32)
            padded[0, :t] = feats
            probs, self.caches = fsmn_vad.apply(
                self.params, torch.from_numpy(padded).to(self.device),
                self.caches, torch.tensor([t], device=self.device))
            with METRICS.stage("vad.fetch"):
                return probs[0, :t].cpu().numpy()

    def accept(self, samples: np.ndarray, is_final: bool = False
               ) -> List[List[int]]:
        with METRICS.stage("vad.frontend"):
            feats = self.frontend.accept(samples, is_final)
        probs = np.zeros((0, self.cfg.output_dim), np.float32)
        if feats.shape[0] > 0:
            probs = self._nn_step(feats)
        if probs.shape[0] == 0 and not is_final:
            return []
        with METRICS.stage("vad.automaton"):
            segs = self.sm(
                probs, samples, is_final=is_final, online=self.online,
                max_end_sil=self.max_end_sil,
                max_single_segment_time=self.max_single_segment,
                speech_noise_thres=self.speech_noise_thres,
            )
        if is_final:
            self.reset()
        return segs


def vad_segments_offline(params, cfg: VadConfig, samples, cmvn=None,
                         window_s: float = 1.0, device="cuda",
                         **kw) -> List[List[int]]:
    """Offline long-audio segmentation: stream fixed windows through an
    online VAD and join the [s,-1]/[-1,e] events into closed [s,e]
    segments."""
    with METRICS.stage("vad.setup"):
        stream = FsmnVadStream(params, cfg, cmvn=cmvn, online=True,
                               device=device, **kw)
    samples = np.asarray(samples, np.float32)
    step = int(cfg.sample_rate * window_s)
    events: List[List[int]] = []
    n = len(samples)
    off = 0
    while off < n:
        chunk = samples[off: off + step]
        is_final = off + step >= n
        events.extend(stream.accept(chunk, is_final))
        off += step
    # merge events into closed segments
    out, start = [], -1
    for s, e in events:
        if s != -1:
            start = s
        if e != -1 and start != -1:
            out.append([start, e])
            start = -1
    return out
