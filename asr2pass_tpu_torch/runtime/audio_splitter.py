"""2pass audio splitter: VAD events -> online chunks + offline segments.

Port copy of the JAX package's runtime/audio_splitter.py (numpy only).
Behavioral port of Audio::Split(vad, chunk_len, input_finished, mode)
(audio.cpp:1257-1425): maintains the utterance sample ring with a 2 s
retention window and maps VAD events {[s,e], [s,-1], [-1,e]} to
  * online frames — chunk_len-sample pieces of the open speech region
    (pass-1 streaming), final-flagged at utterance end
  * offline frames — whole [start,end] VAD segments (pass-2), each with
    global_start/global_end ms for timestamp offsetting
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class AudioFrame:
    """Carries data + global ms bounds (include/audio.h:17-41 role)."""

    data: np.ndarray
    is_final: bool = False
    global_start: int = 0   # ms
    global_end: int = 0     # ms
    # exact epoch-sample range of `data` (samples fed since splitter
    # reset): lets the engine's pass-2 lane gather the segment straight
    # from the device audio ring instead of re-uploading data. -1 = not
    # recorded.
    samp_start: int = -1
    samp_end: int = -1


class TwoPassSplitter:
    def __init__(self, sample_rate: int = 16000, retention_s: float = 2.0):
        self.sr = sample_rate
        self.seg_sample = sample_rate // 1000  # samples per ms
        self.retention = int(sample_rate * retention_s)
        self.reset()

    def reset(self):
        self.all_samples = np.zeros(0, np.float32)
        self.offset = 0          # samples trimmed from the front
        self.speech_start = -1   # ms, open online cursor
        self.speech_offline_start = -1  # ms, open offline segment start
        self.speech_end = 0      # ms, total audio received

    def _slice_ms(self, start_ms: int, end_ms: int) -> np.ndarray:
        a, b = self._range_ms(start_ms, end_ms)
        return self.all_samples[a - self.offset: b - self.offset].copy()

    def _range_ms(self, start_ms: int, end_ms: int):
        """Epoch-sample range [a, b) the ms bounds resolve to after the
        front/back clamps (_slice_ms slices exactly this)."""
        a = max(start_ms * self.seg_sample, self.offset)
        b = min(end_ms * self.seg_sample,
                self.offset + len(self.all_samples))
        return a, max(b, a)

    def feed(self, samples: np.ndarray, vad_events: List[List[int]],
             chunk_len: int, mode: str = "2pass"
             ) -> Tuple[List[AudioFrame], List[AudioFrame]]:
        """samples: new audio; vad_events: this step's VAD output.
        mode: 'online' | 'offline' | '2pass'. Returns (online, offline)."""
        online: List[AudioFrame] = []
        offline: List[AudioFrame] = []
        want_online = mode != "offline"
        want_offline = mode != "online"
        samples = np.asarray(samples, np.float32)
        self.all_samples = np.concatenate([self.all_samples, samples])
        self.speech_end += len(samples) // self.seg_sample
        step_ms = chunk_len // self.seg_sample

        def push_online_chunks(final_end_ms: Optional[int] = None):
            """Drain the open region [speech_start, end) in chunk_len steps;
            if final_end_ms is set, flush everything with a final flag."""
            if self.speech_start == -1 or not want_online:
                return
            end = final_end_ms if final_end_ms is not None else self.speech_end
            while self.speech_start < end:
                remaining = end - self.speech_start
                if final_end_ms is None and remaining < step_ms:
                    break
                take = min(step_ms, remaining)
                is_fin = (final_end_ms is not None
                          and self.speech_start + take >= end)
                online.append(AudioFrame(
                    data=self._slice_ms(self.speech_start,
                                        self.speech_start + take),
                    is_final=is_fin,
                    global_start=self.speech_start,
                    global_end=self.speech_start + take,
                ))
                self.speech_start += take

        if not vad_events:
            push_online_chunks()
        else:
            for ev in vad_events:
                s = ev[0] if ev[0] != -1 else -1
                e = ev[1] if ev[1] != -1 else -1
                if s != -1 and e != -1:
                    # closed segment arriving at once (audio.cpp:1302-1329)
                    data = self._slice_ms(s, e)
                    sa, sb = self._range_ms(s, e)
                    if want_online:
                        online.append(AudioFrame(data=data.copy(),
                                                 is_final=True,
                                                 global_start=s,
                                                 global_end=e))
                    if want_offline:
                        offline.append(AudioFrame(data=data, is_final=True,
                                                  global_start=s,
                                                  global_end=e,
                                                  samp_start=sa,
                                                  samp_end=sb))
                    self.speech_start = -1
                    self.speech_offline_start = -1
                elif s != -1:
                    # segment opens (audio.cpp:1331-1351)
                    self.speech_start = s
                    self.speech_offline_start = s
                    push_online_chunks()
                elif e != -1:
                    # segment closes (audio.cpp:1353-1404)
                    if self.speech_start == -1 or self.speech_offline_start == -1:
                        self.speech_start = max(self.speech_start, 0)
                        self.speech_offline_start = max(
                            self.speech_offline_start, 0)
                    if want_offline:
                        sa, sb = self._range_ms(self.speech_offline_start,
                                                e)
                        offline.append(AudioFrame(
                            data=self._slice_ms(self.speech_offline_start, e),
                            is_final=True,
                            global_start=self.speech_offline_start,
                            global_end=e,
                            samp_start=sa,
                            samp_end=sb,
                        ))
                    if want_online:
                        if e > self.speech_start:
                            push_online_chunks(final_end_ms=e)
                        else:
                            online.append(AudioFrame(
                                data=np.zeros(0, np.float32), is_final=True,
                                global_start=self.speech_start,
                                global_end=e,
                            ))
                    self.speech_start = -1
                    self.speech_offline_start = -1

        # trim the ring: keep 2 s before the open offline segment
        if self.speech_offline_start == -1:
            if len(self.all_samples) > self.retention:
                erase = len(self.all_samples) - self.retention
                self.all_samples = self.all_samples[erase:]
                self.offset += erase
        else:
            keep_from = self.speech_offline_start * self.seg_sample - self.offset
            if keep_from > self.retention:
                erase = keep_from - self.retention
                self.all_samples = self.all_samples[erase:]
                self.offset += erase
        return online, offline
