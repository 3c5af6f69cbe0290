"""E2E VAD decision automaton: a frozen copy of the plain Python frame
loop of the port's vad/e2e_vad.py (E2EVadStateMachine(native=False)),
which follows the reference runtime's onnxruntime/src/e2e-vad.h. The
program runs its native version of this loop; this copy imports nothing of
the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


# frame states
SIL = 0
SPEECH = 1

# machine states
START_NOT_DETECTED = 1
IN_SPEECH = 2
END_DETECTED = 3

# window change states
S2S, S2SIL, SIL2SIL, SIL2S = 0, 1, 2, 3


@dataclass
class VadOptions:
    """Defaults mirror VADXOptions (e2e-vad.h:79-138)."""

    sample_rate: int = 16000
    detect_mode: int = 1              # multiple-utterance
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_2_noise_ratio: float = 1.0
    do_extend: int = 1
    lookback_time_start_point: int = 200
    lookahead_time_end_point: int = 100
    max_single_segment_time: int = 15000
    snr_thres: float = -100.0
    noise_frame_num_used_for_snr: int = 100
    decibel_thres: float = -100.0
    speech_noise_thres: float = 0.6
    sil_pdf_ids: Sequence[int] = (0,)
    frame_in_ms: int = 10
    frame_length_ms: int = 25


class _WindowDetector:
    """Sliding majority window with hysteresis (e2e-vad.h:184-267)."""

    def __init__(self, window_size_ms, sil_to_speech_time, speech_to_sil_time,
                 frame_size_ms):
        self.win_size_frame = window_size_ms // frame_size_ms
        self.sil_to_speech_thres = sil_to_speech_time // frame_size_ms
        self.speech_to_sil_thres = speech_to_sil_time // frame_size_ms
        self.reset()

    def reset(self):
        self.win_sum = 0
        self.win_state = [0] * self.win_size_frame
        self.cur_win_pos = 0
        self.pre_frame_state = SIL

    def detect_one_frame(self, frame_state: int) -> int:
        cur = 1 if frame_state == SPEECH else 0
        self.win_sum += cur - self.win_state[self.cur_win_pos]
        self.win_state[self.cur_win_pos] = cur
        self.cur_win_pos = (self.cur_win_pos + 1) % self.win_size_frame
        if self.pre_frame_state == SIL and self.win_sum >= self.sil_to_speech_thres:
            self.pre_frame_state = SPEECH
            return SIL2S
        if self.pre_frame_state == SPEECH and self.win_sum <= self.speech_to_sil_thres:
            self.pre_frame_state = SIL
            return S2SIL
        return SIL2SIL if self.pre_frame_state == SIL else S2S


@dataclass
class _Segment:
    start_ms: int = 0
    end_ms: int = 0
    contain_start: bool = False
    contain_end: bool = False


class E2EVadStateMachine:
    """Chunk-incremental segmenter. Feed (posteriors, waveform) per chunk;
    returns newly finalized segments."""

    def __init__(self, opts: Optional[VadOptions] = None):
        self.opts = opts or VadOptions()
        self.windows_detector = _WindowDetector(
            self.opts.window_size_ms,
            self.opts.sil_to_speech_time_thres,
            self.opts.speech_to_sil_time_thres,
            self.opts.frame_in_ms,
        )
        self._all_reset()

    # -- reset ------------------------------------------------------------
    def _all_reset(self):
        self.frm_cnt = 0
        self.data_buf_start_frame = 0
        self.latest_confirmed_speech_frame = 0
        self.latest_confirmed_silence_frame = -1
        self.continous_silence_frame_count = 0
        self.vad_state_machine = START_NOT_DETECTED
        self.confirmed_start_frame = -1
        self.confirmed_end_frame = -1
        self.number_end_time_detected = 0
        self.noise_average_decibel = -100.0
        self.next_seg = True
        self.output_data_buf: List[_Segment] = []
        self.output_data_buf_offset = 0
        self.scores: Optional[np.ndarray] = None
        self.idx_pre_chunk = 0
        # decibel history: amortized-growth numpy buffer (frames are
        # appended every chunk and gathered per chunk — a Python list of
        # boxed floats was measurable per tick at engine capacities)
        self._dec_buf = np.empty(1024, np.float64)
        self._dec_n = 0
        self.speech_noise_thres = self.opts.speech_noise_thres
        self.max_end_sil_frame_cnt_thresh = (
            self.opts.max_end_silence_time - self.opts.speech_to_sil_time_thres
        )
        self._reset_detection()

    def _reset_detection(self):
        self.continous_silence_frame_count = 0
        self.latest_confirmed_speech_frame = 0
        self.latest_confirmed_silence_frame = -1
        self.confirmed_start_frame = -1
        self.confirmed_end_frame = -1
        self.vad_state_machine = START_NOT_DETECTED
        self.windows_detector.reset()

    # -- public -----------------------------------------------------------
    def __call__(self, scores, waveform, is_final: bool = False,
                 online: bool = False, max_end_sil: Optional[int] = None,
                 max_single_segment_time: Optional[int] = None,
                 speech_noise_thres: Optional[float] = None
                 ) -> List[List[int]]:
        """scores: [T, pdf] chunk posteriors; waveform: chunk samples.

        Mirrors E2EVadModel::operator() (e2e-vad.h:302-361)."""
        o = self.opts
        self._compute_decibel(np.asarray(waveform, dtype=np.float32))
        scores = np.asarray(scores, dtype=np.float32)
        block = scores.shape[0]

        if max_end_sil is not None:
            self.max_end_sil_frame_cnt_thresh = (
                max_end_sil - o.speech_to_sil_time_thres
            )
        if max_single_segment_time is not None:
            o.max_single_segment_time = max_single_segment_time
        if speech_noise_thres is not None:
            self.speech_noise_thres = speech_noise_thres
        self.scores = scores
        self.frm_cnt += block
        if not is_final:
            self._detect_common_frames(block)
        else:
            self._detect_last_frames(block)
        self.idx_pre_chunk = (self.frm_cnt if not is_final
                              else self.idx_pre_chunk)

        out = self._emit(online, is_final)
        if is_final:
            self._all_reset()
        return out

    def _seg_total(self) -> int:
        return len(self.output_data_buf)

    def _seg_at(self, i: int):
        """(start_ms, end_ms, contain_start, contain_end)"""
        s = self.output_data_buf[i]
        return s.start_ms, s.end_ms, s.contain_start, s.contain_end

    def _emit(self, online: bool, is_final: bool) -> List[List[int]]:
        out: List[List[int]] = []
        i = self.output_data_buf_offset
        total = self._seg_total()
        while i < total:
            start, end, contain_start, contain_end = self._seg_at(i)
            if online:
                if not contain_start:
                    i += 1
                    continue
                if not self.next_seg and not contain_end:
                    i += 1
                    continue
                start_ms = start if self.next_seg else -1
                if contain_end:
                    end_ms = end
                    self.next_seg = True
                    self.output_data_buf_offset += 1
                else:
                    end_ms = -1
                    self.next_seg = False
            else:
                if not is_final and not (contain_start and contain_end):
                    i += 1
                    continue
                start_ms, end_ms = start, end
                self.output_data_buf_offset += 1
            out.append([start_ms, end_ms])
            i += 1
        return out

    # -- internals --------------------------------------------------------
    def _compute_decibel(self, waveform: np.ndarray):
        """Vectorized framewise energy (same values as the per-frame
        np.dot loop): sliding window sums via cumsum — the engine calls
        this once per stream per tick, so the per-frame Python loop was a
        measurable share of the batched tick."""
        o = self.opts
        flen = o.frame_length_ms * o.sample_rate // 1000
        fshift = o.frame_in_ms * o.sample_rate // 1000
        n = len(waveform)
        nf = (n - flen) // fshift + 1 if n >= flen else 0
        if nf <= 0:
            return
        w = waveform.astype(np.float64)
        cs = np.concatenate([[0.0], np.cumsum(w * w)])
        starts = np.arange(nf) * fshift
        energy = cs[starts + flen] - cs[starts]
        new = 10.0 * np.log10(energy + 1e-6)
        need = self._dec_n + len(new)
        if need > len(self._dec_buf):
            grown = np.empty(max(need, 2 * len(self._dec_buf)), np.float64)
            grown[: self._dec_n] = self._dec_buf[: self._dec_n]
            self._dec_buf = grown
        self._dec_buf[self._dec_n: need] = new
        self._dec_n = need

    def _decibel_at(self, t: int) -> float:
        if t < self._dec_n:
            return float(self._dec_buf[t])
        return float(self._dec_buf[self._dec_n - 1]) if self._dec_n else -100.0

    def _decibel_chunk(self, base: int, block: int) -> np.ndarray:
        """Per-frame decibel for frames [base, base+block), clamped to the
        last computed value (the scores stream can outrun the waveform
        stream by a frame at chunk edges)."""
        if self._dec_n == 0:
            return np.full(block, -100.0, np.float64)
        idx = np.minimum(base + np.arange(block), self._dec_n - 1)
        return self._dec_buf[idx]

    def _get_frame_state(self, t: int) -> int:
        o = self.opts
        cur_decibel = self._decibel_at(t)
        cur_snr = cur_decibel - self.noise_average_decibel
        if cur_decibel < o.decibel_thres:
            return SIL
        row = self.scores[t - self.idx_pre_chunk]
        sum_score = float(sum(row[i] for i in o.sil_pdf_ids))
        noise_prob = math.log(max(sum_score, 1e-12)) * o.speech_2_noise_ratio
        speech_prob = math.log(max(1.0 - sum_score, 1e-12))
        if math.exp(speech_prob) >= math.exp(noise_prob) + self.speech_noise_thres:
            if cur_snr >= o.snr_thres and cur_decibel >= o.decibel_thres:
                return SPEECH
            return SIL
        # noise frame: update noise decibel EMA (e2e-vad.h:630-636)
        if self.noise_average_decibel < -99.9:
            self.noise_average_decibel = cur_decibel
        else:
            n = o.noise_frame_num_used_for_snr
            self.noise_average_decibel = (
                cur_decibel + self.noise_average_decibel * (n - 1)
            ) / n
        return SIL

    def _frame_states_chunk(self, block: int):
        """Vectorized _get_frame_state over the chunk: the per-frame log/
        exp/sum probability math rides numpy; only the noise-decibel EMA
        (sequential by definition) stays a slim scalar loop. Decisions are
        identical to calling _get_frame_state per frame (the engine's
        batched tick runs one automaton per stream, so per-frame Python
        math was a measurable share of host time)."""
        o = self.opts
        base = self.frm_cnt - block
        off = base - self.idx_pre_chunk
        ids = list(o.sil_pdf_ids)
        s = self.scores[off: off + block, ids].sum(-1, dtype=np.float32) \
            .astype(np.float64)
        # same exp(log(max(.))) composition as the scalar path so rounding
        # matches bit-for-bit
        noise_p = np.exp(np.log(np.maximum(s, 1e-12))
                         * o.speech_2_noise_ratio)
        speech_p = np.exp(np.log(np.maximum(1.0 - s, 1e-12)))
        prob_speech = (speech_p >= noise_p
                       + self.speech_noise_thres).tolist()
        dec = self._decibel_chunk(base, block)
        states = [SIL] * block
        ema = self.noise_average_decibel
        n = o.noise_frame_num_used_for_snr
        for i in range(block):
            d = dec[i]
            if d < o.decibel_thres:
                continue
            if prob_speech[i]:
                if d - ema >= o.snr_thres:
                    states[i] = SPEECH
            elif ema < -99.9:
                ema = d
            else:
                ema = (d + ema * (n - 1)) / n
        self.noise_average_decibel = ema
        return states

    def _detect_common_frames(self, block: int):
        if self.vad_state_machine == END_DETECTED:
            return
        states = self._frame_states_chunk(block)
        base = self.frm_cnt - block
        for i in range(block):
            self._detect_one_frame(states[i], base + i, False)

    def _detect_last_frames(self, block: int):
        if self.vad_state_machine == END_DETECTED:
            return
        states = self._frame_states_chunk(block)
        base = self.frm_cnt - block
        for i in range(block):
            self._detect_one_frame(states[i], base + i, i == block - 1)

    def _latency_frames(self) -> int:
        o = self.opts
        latency = self.windows_detector.win_size_frame
        if o.do_extend:
            latency += o.lookback_time_start_point // o.frame_in_ms
        return latency

    # segment bookkeeping (PopDataToOutputBuf role, e2e-vad.h:471-522)
    def _pop_to_output(self, start_frm: int, frm_cnt: int,
                       first_is_start: bool, last_is_end: bool):
        ms = self.opts.frame_in_ms
        if not self.output_data_buf or first_is_start:
            seg = _Segment(start_ms=start_frm * ms, end_ms=start_frm * ms)
            self.output_data_buf.append(seg)
        cur = self.output_data_buf[-1]
        self.data_buf_start_frame = max(self.data_buf_start_frame,
                                        start_frm + frm_cnt)
        cur.end_ms = (start_frm + frm_cnt) * ms
        if first_is_start:
            cur.contain_start = True
        if last_is_end:
            cur.contain_end = True

    def _on_silence_detected(self, t: int):
        self.latest_confirmed_silence_frame = t
        if self.vad_state_machine == START_NOT_DETECTED:
            self.data_buf_start_frame = max(self.data_buf_start_frame, t)

    def _on_voice_detected(self, t: int):
        self.latest_confirmed_speech_frame = t
        self._pop_to_output(t, 1, False, False)

    def _on_voice_start(self, t: int, fake: bool = False):
        if self.confirmed_start_frame == -1:
            self.confirmed_start_frame = t
        if not fake and self.vad_state_machine == START_NOT_DETECTED:
            self._pop_to_output(self.confirmed_start_frame, 1, True, False)

    def _on_voice_end(self, t: int, fake: bool, is_last: bool):
        for f in range(self.latest_confirmed_speech_frame + 1, t):
            self._on_voice_detected(f)
        if self.confirmed_end_frame == -1:
            self.confirmed_end_frame = t
        if not fake:
            self._pop_to_output(self.confirmed_end_frame, 1, False, True)
        self.number_end_time_detected += 1

    def _maybe_end_last_frame(self, is_final_frame: bool, t: int):
        if is_final_frame:
            self._on_voice_end(t, False, True)
            self.vad_state_machine = END_DETECTED

    def _detect_one_frame(self, frame_state: int, t: int,
                          is_final_frame: bool):
        o = self.opts
        change = self.windows_detector.detect_one_frame(frame_state)
        ms = o.frame_in_ms
        if change == SIL2S:
            self.continous_silence_frame_count = 0
            if self.vad_state_machine == START_NOT_DETECTED:
                start = max(self.data_buf_start_frame,
                            t - self._latency_frames())
                self._on_voice_start(start)
                self.vad_state_machine = IN_SPEECH
                for f in range(start + 1, t + 1):
                    self._on_voice_detected(f)
            elif self.vad_state_machine == IN_SPEECH:
                for f in range(self.latest_confirmed_speech_frame + 1, t):
                    self._on_voice_detected(f)
                if t - self.confirmed_start_frame + 1 > o.max_single_segment_time // ms:
                    self._on_voice_end(t, False, False)
                    self.vad_state_machine = END_DETECTED
                elif not is_final_frame:
                    self._on_voice_detected(t)
                else:
                    self._maybe_end_last_frame(is_final_frame, t)
        elif change == S2SIL:
            self.continous_silence_frame_count = 0
            if self.vad_state_machine == IN_SPEECH:
                if t - self.confirmed_start_frame + 1 > o.max_single_segment_time // ms:
                    self._on_voice_end(t, False, False)
                    self.vad_state_machine = END_DETECTED
                elif not is_final_frame:
                    self._on_voice_detected(t)
                else:
                    self._maybe_end_last_frame(is_final_frame, t)
        elif change == S2S:
            self.continous_silence_frame_count = 0
            if self.vad_state_machine == IN_SPEECH:
                if t - self.confirmed_start_frame + 1 > o.max_single_segment_time // ms:
                    self._on_voice_end(t, False, False)
                    self.vad_state_machine = END_DETECTED
                elif not is_final_frame:
                    self._on_voice_detected(t)
                else:
                    self._maybe_end_last_frame(is_final_frame, t)
        elif change == SIL2SIL:
            self.continous_silence_frame_count += 1
            if self.vad_state_machine == START_NOT_DETECTED:
                single_mode = o.detect_mode == 0
                if ((single_mode and self.continous_silence_frame_count * ms
                     > o.max_start_silence_time)
                        or (is_final_frame and self.number_end_time_detected == 0)):
                    for f in range(self.latest_confirmed_silence_frame + 1, t):
                        self._on_silence_detected(f)
                    self._on_voice_start(0, fake=True)
                    self._on_voice_end(0, fake=True, is_last=False)
                    self.vad_state_machine = END_DETECTED
                else:
                    if t >= self._latency_frames():
                        self._on_silence_detected(t - self._latency_frames())
            elif self.vad_state_machine == IN_SPEECH:
                if (self.continous_silence_frame_count * ms
                        >= self.max_end_sil_frame_cnt_thresh):
                    lookback = self.max_end_sil_frame_cnt_thresh // ms
                    if o.do_extend:
                        lookback -= o.lookahead_time_end_point // ms
                        lookback -= 1
                        lookback = max(0, lookback)
                    self._on_voice_end(t - lookback, False, False)
                    self.vad_state_machine = END_DETECTED
                elif (t - self.confirmed_start_frame + 1
                      > o.max_single_segment_time // ms):
                    self._on_voice_end(t, False, False)
                    self.vad_state_machine = END_DETECTED
                elif o.do_extend and not is_final_frame:
                    if (self.continous_silence_frame_count
                            <= o.lookahead_time_end_point // ms):
                        self._on_voice_detected(t)
                else:
                    self._maybe_end_last_frame(is_final_frame, t)

        if (self.vad_state_machine == END_DETECTED
                and o.detect_mode == 1):
            self._reset_detection()
