"""Whole-file offline transcription (FunOfflineInferBuffer equivalent).

Counterpart of the JAX package's runtime/offline_api.py. The VAD runs on the
recognizer's device. Pipeline per funasrruntime.cpp:208-337: load audio
-> VAD segmentation (1 s-windowed online VAD, CutSplit role) -> batched
pass over segments
(feature-bucket batching replaces length sorting) -> reassemble in original
order with global timestamps -> punctuation over the full text -> optional
ITN + timestamp smoothing -> sentence records.

Each call is one request of runtime/metrics: its record (the spans
offline.request, offline.vad, offline.asr, offline.punc and those inside
them, and the recognizer's counters) comes back as OfflineResult.trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.punc import Punctuator
from asr2pass_tpu_torch.runtime.vad_stream import vad_segments_offline
from asr2pass_tpu_torch.text import timestamps as ts_mod


@dataclass
class OfflineResult:
    text: str = ""
    timestamps: List[List[int]] = field(default_factory=list)
    stamp_sents: List[dict] = field(default_factory=list)
    snippet_time: float = 0.0
    segments: List[List[int]] = field(default_factory=list)  # VAD [s,e] ms
    # the request's span record (runtime/metrics.Metrics.request); not a
    # dataclass field, so results compare and convert by their content
    trace = None


class OfflineRecognizer:
    """asr: a ParaformerOffline or a SenseVoiceOffline (the same
    recognize_batch interface); vad_params: an FsmnVad module or its
    state dict (None: the whole file is one segment); itn: any object
    with normalize(text)."""

    def __init__(self, asr: ParaformerOffline,
                 vad_params=None, vad_cfg=None, vad_cmvn=None,
                 punc: Optional[Punctuator] = None,
                 itn: Optional[Any] = None,
                 vad_tail_sil: int = 800, vad_max_len: int = 60000):
        self.asr = asr
        self.vad_params = vad_params
        self.vad_cfg = vad_cfg
        self.vad_cmvn = vad_cmvn
        self.punc = punc
        self.itn = itn
        self.vad_tail_sil = vad_tail_sil
        self.vad_max_len = vad_max_len

    def transcribe(self, samples: np.ndarray, hw_emb=None,
                   use_itn: bool = True, vad_tail_sil: Optional[int] = None,
                   vad_max_len: Optional[int] = None) -> OfflineResult:
        with METRICS.request() as record, METRICS.stage("offline.request"):
            res = self._transcribe(samples, hw_emb, use_itn, vad_tail_sil,
                                   vad_max_len)
        res.trace = record
        return res

    def _transcribe(self, samples, hw_emb, use_itn, vad_tail_sil,
                    vad_max_len) -> OfflineResult:
        samples = np.asarray(samples, np.float32)
        sr = self.asr.cfg.frontend.fs
        res = OfflineResult(snippet_time=len(samples) / sr)
        if res.snippet_time == 0:
            return res
        if self.vad_params is not None:
            with METRICS.stage("offline.vad"):
                segs = vad_segments_offline(
                    self.vad_params, self.vad_cfg, samples,
                    cmvn=self.vad_cmvn,
                    max_end_sil=vad_tail_sil or self.vad_tail_sil,
                    max_single_segment=vad_max_len or self.vad_max_len,
                    device=self.asr.device,
                )
        else:
            segs = [[0, int(1000 * res.snippet_time)]]
        res.segments = segs
        if not segs:
            return res
        seg_audio = [samples[s * sr // 1000: e * sr // 1000] for s, e in segs]
        with METRICS.stage("offline.asr"):
            outs = self.asr.recognize_batch(seg_audio, hw_emb)
        lang = self.asr.cfg.lang
        parts: List[str] = []
        for (text, merged), (s, _e) in zip(outs, segs):
            if not text:
                continue
            if lang == "en-bpe" and parts:
                parts.append(" ")
            parts.append(text)
            res.timestamps.extend(ts_mod.stamps_to_ms(merged, s / 1000.0))
        text = "".join(parts)
        if self.punc is not None and text:
            with METRICS.stage("offline.punc"):
                text = self.punc.add_punc(text, lang)
        if self.itn is not None and use_itn and text:
            text_itn = self.itn.normalize(text)
            if res.timestamps:
                smoothed = ts_mod.timestamp_smooth(text, text_itn,
                                                   res.timestamps)
                if smoothed:
                    res.timestamps = smoothed
            text = text_itn
        res.text = text
        if res.timestamps:
            res.stamp_sents = ts_mod.timestamp_sentence(text, res.timestamps)
        return res
