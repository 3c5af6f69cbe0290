"""TwoPassSession: the per-connection 2pass orchestrator.

Counterpart of the JAX package's runtime/two_pass.py: each model runs on the
device of its own wrapper (FsmnVadStream, ParaformerOnlineStream,
ParaformerOffline, Punctuator), and the splitter and the text work stay
on the host. Equivalent of FunTpassInferBuffer (funasrruntime.cpp:491-646) plus the
per-connection state of FUNASR_MESSAGE (websocket-server-2pass.h:49-65):
feed PCM, get back pass-1 partials immediately and pass-2 corrected finals
(with punctuation, optional ITN, timestamps, sentence records) at VAD
endpoints. Modes 'online' / 'offline' / '2pass' select which passes run
(README.md:95-190 protocol semantics).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from asr2pass_tpu_torch.frontend.audio import quantize_pcm
from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
from asr2pass_tpu_torch.runtime.audio_splitter import TwoPassSplitter
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.punc import Punctuator
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream
from asr2pass_tpu_torch.text import timestamps as ts_mod


@dataclass
class TwoPassResult:
    """One feed() step's outputs (FUNASR_RECOG_RESULT role)."""

    partial: str = ""          # pass-1 text added this step (msg)
    final_text: str = ""       # pass-2 corrected text (tpass_msg)
    online_final: str = ""     # online-mode punctuated utterance text
    timestamps: List[List[int]] = field(default_factory=list)
    stamp_sents: List[dict] = field(default_factory=list)
    snippet_time: float = 0.0


class TwoPassSession:
    def __init__(self,
                 vad: FsmnVadStream,
                 online_asr: Optional[ParaformerOnlineStream],
                 offline_asr: Optional[ParaformerOffline],
                 punc: Optional[Punctuator] = None,
                 itn: Optional[Any] = None,
                 mode: str = "2pass",
                 hw_emb: Optional[np.ndarray] = None,
                 use_itn: bool = True):
        assert mode in ("online", "offline", "2pass")
        self.vad = vad
        self.online_asr = online_asr
        self.offline_asr = offline_asr
        self.punc = punc
        self.itn = itn
        self.mode = mode
        self.hw_emb = hw_emb
        self.use_itn = use_itn
        sr = vad.cfg.sample_rate
        self.splitter = TwoPassSplitter(sr)
        # chunk_len = center * frame_shift * lfr_n samples
        # (paraformer-online.cpp:112)
        if online_asr is not None:
            c = online_asr.cfg
            self.chunk_len = (c.chunk_size[1] * c.frontend.frame_shift
                              * c.frontend.lfr_n)
        else:
            self.chunk_len = 9600
        # punc caches: [0] online-mode utterances, [1] 2pass finals
        # (websocket-server-2pass.h:52 punc_cache)
        self.punc_cache: List[List[str]] = [[], []]
        self._online_res = ""  # online-mode per-utterance accumulator

    def reset(self):
        self.vad.reset()
        if self.online_asr is not None:
            self.online_asr.reset()
        self.splitter.reset()
        self.punc_cache = [[], []]
        self._online_res = ""

    # ------------------------------------------------------------------
    def _finalize_segment(self, frame) -> Dict[str, Any]:
        """Pass-2 on one VAD segment: offline ASR + punc + ITN + stamps."""
        text, merged_ts = self.offline_asr.recognize(frame.data, self.hw_emb)
        stamps = ts_mod.stamps_to_ms(merged_ts, frame.global_start / 1000.0)
        out: Dict[str, Any] = {"text": text, "stamps": stamps}
        if self.punc is not None and text:
            text = self.punc.add_punc_streaming(text, self.punc_cache[1])
        if self.itn is not None and self.use_itn and text:
            text_itn = self.itn.normalize(text)
            if stamps:
                smoothed = ts_mod.timestamp_smooth(text, text_itn, stamps)
                if smoothed:
                    stamps = smoothed
            text = text_itn
        out["text"] = text
        out["stamps"] = stamps
        out["stamp_sents"] = (ts_mod.timestamp_sentence(text, stamps)
                              if stamps else [])
        return out

    def feed(self, samples: np.ndarray, is_final: bool = False
             ) -> TwoPassResult:
        """Feed PCM samples (float32 [-1,1]); returns this step's results."""
        samples = quantize_pcm(samples)
        res = TwoPassResult(snippet_time=len(samples) / self.splitter.sr)
        events = self.vad.accept(samples, is_final)
        online_frames, offline_frames = self.splitter.feed(
            samples, events, self.chunk_len, self.mode
        )

        if self.online_asr is not None and self.mode != "offline":
            for fr in online_frames:
                msg = self.online_asr.accept(fr.data, fr.is_final)
                res.partial += msg
                if self.mode == "online":
                    self._online_res += msg
                    if fr.is_final:
                        text = self._online_res
                        self._online_res = ""
                        if self.punc is not None and text:
                            text = self.punc.add_punc_streaming(
                                text, self.punc_cache[0])
                        if self.itn is not None and self.use_itn and text:
                            text = self.itn.normalize(text)
                        res.online_final += text

        if self.offline_asr is not None and self.mode != "online":
            for fr in offline_frames:
                out = self._finalize_segment(fr)
                text = out["text"]
                if is_final and self.punc is not None and text:
                    text += "。"
                res.final_text += text
                res.timestamps.extend(out["stamps"])
                res.stamp_sents.extend(out["stamp_sents"])

        if is_final:
            self.splitter.reset()
        return res
