"""StreamEngine: S concurrent 2pass streams through shared batched steps.

Counterpart of the JAX package's runtime/engine.py. All active streams
advance together, each tick:

  * one batched fused VAD step for every slot's new audio (fbank, LFR,
    CMVN, FSMN-VAD), with the decision automatons on the host
  * one batched fused pass-1 step per round (fbank, LFR, CMVN, the
    pending-feature ring, paraformer_online.step); the per-slot chunk
    counts, final flags and state resets ride the leading axis
  * pass-2 segments from every stream pool into one bucketed
    recognize_batch, their features gathered from the device audio ring:
    ParaformerOffline with each slot's hotword embeddings, or, when the
    models carry SenseVoice, SenseVoiceOffline with each slot's language,
    ITN token and hotword context graph; with an LM loaded, each with the
    slot's LM decoder (the shared native decoder, a clone biased by the
    connection's hotwords, or a TlgDecoder of its own)

Slots are fixed (capacity), so the tick's launches do not grow with the
number of streams: every ring write and gather is one batched indexed op
over all slots, and inactive slots compute zeros. Per-slot host state
(front-end counters, VAD automaton, splitter, punctuation cache,
detokenizer state) is O(text) work.

Device order. The tick and the lanes (pass-1 collector, VAD decide,
upload, pass 2) enqueue on the device's default stream, where the device
runs work in enqueue order. The audio ring, the pending-feature ring and
the per-slot state are updated in place; a gather enqueued after a write
reads what the write left, which the pass-2 lane's freshness check relies
on. Every lane enters torch.inference_mode() in its own body.
"""
from __future__ import annotations

import functools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch

from asr2pass_tpu_torch.frontend.audio import quantize_pcm
from asr2pass_tpu_torch.frontend.fbank import get_extractor, num_frames
from asr2pass_tpu_torch.models import fsmn_vad, paraformer_online
from asr2pass_tpu_torch.runtime import streaming_frontend as sf
from asr2pass_tpu_torch.runtime.audio_splitter import (AudioFrame,
                                                      TwoPassSplitter)
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
from asr2pass_tpu_torch.runtime.vad_stream import vad_options
from asr2pass_tpu_torch.text import timestamps as ts_mod
from asr2pass_tpu_torch.text.vocab import Vocab
from asr2pass_tpu_torch.utils import to_device, to_host
from asr2pass_tpu_torch.vad.e2e_vad import E2EVadStateMachine

log = logging.getLogger("asr2pass.engine")


class EngineAtCapacity(RuntimeError):
    """Every slot is active or still draining in-flight work. The server
    answers with a protocol error result instead of dropping the socket
    (the reference accepts and queues via its thread pool,
    websocket-server-2pass.cpp:278-366; here capacity is a hard batch
    dimension, so the client is told to retry)."""


def _vad_bucket(fcfg) -> int:
    """Mel rows computed per fused-VAD tick: the engine stages up to
    64*lfr_n mel frames of audio per slot per tick (one ~0.64 s chunk of
    LFR rows), plus margin for the LFR/residual carry."""
    return 64 * fcfg.lfr_n + 8


# device-resident per-slot audio ring (samples; int16): written once a
# tick by the fused VAD step from its staged upload, read by the fused
# pass-1 step and gathered by the pass-2 lane, so raw audio crosses to
# the device once. 2^19 samples = 32.8 s per slot: the longest 2pass
# segment (vad_max_len 15-20 s) plus seconds of lane lag.
_RING_SAMPLES = 1 << 19

_P1_FRAMES = 68          # max new mel frames staged per pass-1 round


def _frames_cols(fcfg, nf: int, device) -> torch.Tensor:
    """Ring offsets of nf fbank frames' samples, flattened [nf*flen]."""
    return (torch.arange(nf, device=device)[:, None] * fcfg.frame_shift
            + torch.arange(fcfg.frame_length, device=device)[None, :]
            ).reshape(-1)


def _lfr_taps(fcfg, n_win: int, device) -> torch.Tensor:
    """Mel-row tap of LFR window i, tap m, relative to the first window's
    first row: i*lfr_n + m - left, [n_win, lfr_m]."""
    left = (fcfg.lfr_m - 1) // 2
    return (torch.arange(n_win, device=device)[:, None] * fcfg.lfr_n
            + torch.arange(fcfg.lfr_m, device=device)[None, :] - left)


def _ring_mel(ex, fcfg, ring, start, cols, capacity: int, nf: int):
    """fbank of nf frames per slot read from the int16 ring at `start`
    (modular indices handle the wrap) -> [C, nf, n_mels]."""
    r = ring.shape[1]
    frames = ring.gather(1, (start[:, None] + cols[None, :]) % r)
    return ex.frames_to_mel(
        frames.float().reshape(capacity * nf, fcfg.frame_length)
        * (fcfg.scale_input / 32768.0)).reshape(capacity, nf, -1)


def _lfr_gather(fcfg, combined, taps, win_start, total_new, base,
                hist_len: int, n_rows: int):
    """LFR windows win_start.. from the combined [history | new] mel rows,
    taps clamped to the valid rows (first-window left pad, final-flush
    tail repeat: StreamingFrontend._emit_windows)."""
    c, n_win = combined.shape[0], taps.shape[0]
    g = win_start[:, None, None] * fcfg.lfr_n + taps[None]
    g = torch.minimum(g.clamp_min(0),
                      (total_new - 1).clamp_min(0)[:, None, None])
    local = (g - (base - hist_len)[:, None, None]).clamp(0, n_rows - 1)
    return torch.take_along_dim(
        combined, local.reshape(c, -1, 1), dim=1
    ).reshape(c, n_win, fcfg.lfr_m * fcfg.n_mels)


@functools.lru_cache(maxsize=8)
def _fused_vad_step(fcfg, capacity: int, sil_pdf_ids=(0,),
                    ring_samples: int = _RING_SAMPLES,
                    device=torch.device("cpu")):
    """One batched step: write the tick's new samples into the device
    audio ring, read each slot's fbank window back from it, fbank -> LFR
    window gather -> CMVN -> FSMN-VAD, with the lfr_m-1 mel frames of
    cross-tick context held in a device history. The index tensors are
    built once per (config, capacity, device). Window accounting
    (totals, next window) stays on the host as O(1) counters. Returns
    (step, need, max_new)."""
    ex = get_extractor(fcfg)
    nf = _vad_bucket(fcfg)
    need = fcfg.frame_length + (nf - 1) * fcfg.frame_shift
    hist_len = fcfg.lfr_m - 1
    max_new = 64 * fcfg.lfr_n * fcfg.frame_shift  # staging cap (samples)
    cols = _frames_cols(fcfg, nf, device)
    taps = _lfr_taps(fcfg, nf, device)
    jar = torch.arange(max_new, device=device)
    har = torch.arange(hist_len, device=device)
    sil_ids = torch.tensor(sil_pdf_ids, device=device)

    @torch.inference_mode()
    def step(params, means, vars_, waves_new, n_new, win_start, total_new,
             k_emit, finals, hist, caches, ring, ring_off, n_samp,
             win_off):
        # 1. the new samples (int16, PCM-grid exact) into the ring, in
        # place: positions ring_off + j, j < n_samp; the rest of the
        # max_new window is written back unchanged. The host caps
        # staging so a write never passes the ring end.
        pos = (ring_off[:, None] + jar[None, :]) % ring_samples
        keep = jar[None, :] < n_samp[:, None]
        ring.scatter_(1, pos, torch.where(keep, waves_new,
                                          ring.gather(1, pos)))
        # 2. each slot's fbank window (framing residual + new samples)
        # from the updated ring. Samples past the valid window read stale
        # ring data, but every consumer is masked: the LFR gather clamps
        # to total_new, fsmn_vad.apply advances the caches by exactly
        # k_emit, and the automaton reads only k_emit posterior rows.
        mel_new = _ring_mel(ex, fcfg, ring, win_off, cols, capacity, nf)
        combined = torch.cat([hist, mel_new], dim=1)      # [C, H+nf, M]
        feats = _lfr_gather(fcfg, combined, taps, win_start, total_new,
                            total_new - n_new, hist_len, hist_len + nf)
        feats = (feats + means) * vars_
        probs, new_caches = fsmn_vad.apply(params, feats, caches, k_emit)
        # the automaton consumes only the summed silence posterior per
        # frame: one [C, nf] tensor comes back, not [C, nf, pdfs]
        sil = probs[:, :, sil_ids].sum(-1)
        hidx = n_new[:, None] + har[None, :]
        new_hist = torch.take_along_dim(combined, hidx[:, :, None], dim=1)
        new_hist = torch.where(finals.bool()[:, None, None], 0.0, new_hist)
        return sil, new_hist, new_caches

    return step, need, max_new


@functools.lru_cache(maxsize=8)
def _fused_p1_step(ocfg, capacity: int, ring_samples: int = _RING_SAMPLES,
                   device=torch.device("cpu")):
    """One batched step for the whole pass-1 lane: fbank over the staged
    speech samples read from the device audio ring -> LFR window gather
    -> CMVN -> append into a device pending-feature ring -> consume one
    exact-`center` chunk per slot -> paraformer_online.step.

    The host keeps every counter (mel totals, next LFR window, ring read
    and write offsets) as exact mirrors of StreamingFrontend's
    accounting; the model consumes exactly `center` rows (or a final
    partial), funasr's 600 ms cadence. Returns (step, need, hist, ring_n,
    k_max)."""
    fcfg = ocfg.frontend
    ex = get_extractor(fcfg)
    nf = _P1_FRAMES
    need = fcfg.frame_length + (nf - 1) * fcfg.frame_shift
    center = ocfg.chunk_size[1]
    # max LFR windows emitted per round / mel history / pending-ring rows
    k_max = nf // fcfg.lfr_n + 2
    hist = fcfg.lfr_m + fcfg.lfr_n + 8       # > max un-consumed mel rows
    ring_n = 1
    while ring_n < k_max + center + 2:
        ring_n *= 2
    cols = _frames_cols(fcfg, nf, device)
    taps = _lfr_taps(fcfg, k_max, device)
    rows = torch.arange(capacity, device=device)[:, None]
    kar = torch.arange(k_max, device=device)
    car = torch.arange(center, device=device)
    har = torch.arange(hist, device=device)

    @torch.inference_mode()
    def step(params, means, vars_, state, audio_ring, start_off, n_new,
             win_start, total_new, k_emit, fe_finals, ring_woff,
             consume_start, consume_count, finals, mel_hist, ring):
        mel_new = _ring_mel(ex, fcfg, audio_ring, start_off, cols,
                            capacity, nf)
        combined = torch.cat([mel_hist, mel_new], dim=1)
        feats = _lfr_gather(fcfg, combined, taps, win_start, total_new,
                            total_new - n_new, hist, hist + nf)
        feats = (feats + means) * vars_
        # masked append into each slot's pending ring, in place
        widx = (ring_woff[:, None] + kar[None, :]) % ring_n
        wmask = kar[None, :] < k_emit[:, None]
        ring[rows, widx] = torch.where(wmask[:, :, None], feats,
                                       ring[rows, widx])
        # consume one exact-center chunk per slot (count 0 = no-op slot)
        chunk = ring[rows, (consume_start[:, None] + car[None, :]) % ring_n]
        new_state, ids, nums = paraformer_online.step(
            params, ocfg, state, chunk, consume_count, finals.bool())
        # slide the mel history to the last `hist` rows; utterance-final
        # slots reset their front-end
        hidx = n_new[:, None] + har[None, :]
        new_hist = torch.take_along_dim(combined, hidx[:, :, None], dim=1)
        new_hist = torch.where(fe_finals.bool()[:, None, None], 0.0,
                               new_hist)
        return new_state, ids, nums, new_hist

    return step, need, hist, ring_n, k_max


@dataclass
class _Slot:
    active: bool = False
    # connection generation: bumped on every _reset_slot. The async lanes
    # capture the _Slot OBJECT at dispatch time and post results/decrement
    # counters on that object only — a reclaimed slot index can never
    # receive a previous connection's transcript (the reference guards the
    # same lifecycle with access_num refcounts + an is_eof reaper,
    # websocket-server-2pass.cpp:278-366,293-300)
    gen: int = 0
    vad_frontend: Any = None
    sm: Any = None
    splitter: Any = None
    vocab: Any = None
    audio_in: list = field(default_factory=list)   # (samples, is_final)
    seg_queue: list = field(default_factory=list)  # offline AudioFrames
    punc_cache: list = field(default_factory=list)
    results: list = field(default_factory=list)
    # per-connection first-message options (the reference plumbs all of
    # these per connection, websocket-server-2pass.cpp:424-523)
    mode: str = "2pass"                # "2pass" or "online"
    use_itn: bool = True
    hw_emb: Any = None                 # compiled hotword embeddings [N, D]
    svs_lang: Any = None               # SenseVoice language (None: auto)
    svs_itn: Any = None                # SenseVoice ITN token (None: on)
    svs_context: Any = None            # SenseVoice hotword ContextGraph
    lm_decoder: Any = None             # the connection's LM decoder
    vad_tail_sil: Any = None           # max_end_silence override (ms)
    vad_max_len: Any = None            # max_single_segment override (ms)
    speech_noise_thres: Any = None
    p2_inflight: int = 0               # segments handed to the pass-2 lane
    p1_inflight: int = 0               # chunks in the dispatched-not-yet-
                                       # fetched pass-1 batch (pipelining)
    vd_inflight: int = 0               # VAD posterior batches dispatched
                                       # but not yet decided (async lane)
    vd_abs: int = 0                    # decide-side absolute sample count
    splitter_base: int = 0             # abs sample of the splitter epoch
    # fused pass-1 front-end host mirrors (exact StreamingFrontend
    # accounting; the audio AND the mel stay device-resident)
    p1_groups: list = field(default_factory=list)  # (abs_start, n, final)
    p1_residual: int = 0               # samples staged but not yet framed
    p1_cursor: int = 0                 # absolute index of next unframed sample
    p1_total: int = 0                  # mel frames produced this utterance
    p1_win: int = 0                    # next LFR window index
    p1_ring_w: int = 0                 # pending-ring windows written (monotonic)
    p1_ring_r: int = 0                 # pending-ring windows consumed
    p1_flush_at: Any = None            # ring_w at utterance final, or None
    # the utterance pass 1 is in: its first staged sample and its end
    # (absolute), and the LFR rows consumed of it; they give each partial
    # the sample count it waited for (the result's "end_sample")
    p1_utt_start: int = 0
    p1_utt_end: int = 0
    p1_utt_rows: int = 0


class StreamEngine:
    """Batched serving of up to `capacity` 2pass/online streams on the
    device of `models` (a server.engine.ServerModels). Ticks:
      * default: VAD dispatch + inline decide, pass-1 batches fetched on
        a collector thread (pipeline)
      * vad_async: the posterior fetch + automaton + splitter on a
        decide lane
      * fused_fetch (the serving default): dispatch VAD and pass 1, then
        ONE combined fetch a tick; with upload_overlap the next tick's
        audio is staged and uploaded during the fetch, with decide_async
        the automatons run on the decide lane
    pass2_async decodes segments on a background lane."""

    def __init__(self, models, capacity: int = 64, mode: str = "2pass",
                 pass2_async: bool = False, pipeline: bool = True,
                 vad_async: bool = False, fused_fetch: bool = False,
                 upload_overlap: bool = False,
                 decide_async: bool = False,
                 ring_samples: int = _RING_SAMPLES):
        self.models = models
        self.device = dev = models.device
        self.capacity = capacity
        self._ring_samples = ring_samples
        self.mode = mode
        ocfg = models.online_cfg or models.asr_cfg
        self.ocfg = ocfg
        self.oparams = (models.online_params
                        if models.online_params is not None
                        else models.asr_params)
        self.offline = None
        if mode != "online":
            self.offline = models.create_offline_recognizer(
                use_svs=models.svs_params is not None)
        self.punc = models._punctuator()
        self.slots: List[_Slot] = [_Slot() for _ in range(capacity)]
        self.chunk_len = (ocfg.chunk_size[1] * ocfg.frontend.frame_shift
                          * ocfg.frontend.lfr_n)
        self.center = ocfg.chunk_size[1]
        # fused VAD front-end+NN (one step a tick); host-side window
        # counters + device-resident mel history
        fcfg = models.vad_cfg.frontend
        self._vad_step, _, self._vad_max_new = _fused_vad_step(
            fcfg, capacity, tuple(models.vad_cfg.sil_pdf_ids),
            ring_samples, dev)
        (self._p1_step, self._p1_need, self._p1_hist_n, self._p1_ring_n,
         self._p1_kmax) = _fused_p1_step(ocfg, capacity, ring_samples, dev)
        if ring_samples < self._p1_need + 4 * self._vad_max_new:
            # below this, the pass-1 backlog guard quarantines healthy
            # streams (window + a few ticks of decide-lane lag must fit)
            raise ValueError(
                f"ring_samples={ring_samples} too small: pass-1 needs a "
                f"{self._p1_need}-sample window plus staging lag "
                f"(>= {self._p1_need + 4 * self._vad_max_new})")
        afc = ocfg.frontend

        def cmvn(pair, d):
            means, vars_ = (pair if pair is not None and pair[0] is not None
                            else (np.zeros(d, np.float32),
                                  np.ones(d, np.float32)))
            return (torch.as_tensor(np.asarray(means, np.float32),
                                    device=dev),
                    torch.as_tensor(np.asarray(vars_, np.float32),
                                    device=dev))

        self._vad_means, self._vad_vars = cmvn(models.vad_cmvn, fcfg.lfr_dim)
        self._asr_means, self._asr_vars = cmvn(models.asr_cmvn, afc.lfr_dim)
        # every device buffer is an inference tensor, updated in place
        # under torch.inference_mode() by whichever thread owns it
        with torch.inference_mode():
            self.online_state = paraformer_online.init_state(
                self.oparams, ocfg, capacity)
            self.vad_caches = fsmn_vad.init_caches(models.vad_cfg,
                                                   capacity, dev)
            self._vad_hist = torch.zeros(
                (capacity, fcfg.lfr_m - 1, fcfg.n_mels), device=dev)
            self._p1_hist = torch.zeros(
                (capacity, self._p1_hist_n, afc.n_mels), device=dev)
            self._p1_ring = torch.zeros(
                (capacity, self._p1_ring_n, afc.lfr_dim), device=dev)
            # device audio ring: written once per tick by the fused VAD
            # step, read by pass 1 and gathered by the pass-2 lane
            self._audio_ring = torch.zeros((capacity, ring_samples),
                                           dtype=torch.int16, device=dev)
        self._vad_total = np.zeros(capacity, np.int64)
        self._vad_next = np.zeros(capacity, np.int64)
        self._abs_fed = np.zeros(capacity, np.int64)
        # pass-1 / pass-2 priority lanes (SURVEY §7 "latency vs batching
        # tension"): with pass2_async the tick never runs offline decodes —
        # segments go to a background worker thread, so a burst of long
        # segments cannot stall pass-1 partials for every stream
        self._results_lock = threading.Lock()
        self._p2_async = pass2_async
        self._p2_queue: "queue.Queue" = queue.Queue()
        self._p2_thread = None
        if pass2_async and self.offline is not None:
            self._p2_thread = threading.Thread(
                target=self._p2_worker, daemon=True, name="pass2-lane")
            self._p2_thread.start()
        # fused-fetch tick: ONE combined fetch per tick for the VAD
        # posteriors and the pass-1 ids; pass 1 stages the PREVIOUS
        # fetch's decisions (one loop iteration of added latency)
        self._fused_fetch = fused_fetch
        if fused_fetch:
            pipeline = False
            vad_async = False
        # pipelined tick: pass-1 batches are dispatched by the tick but
        # fetched + detokenized on a collector thread; one FIFO worker
        # keeps per-slot result order, p1_inflight keeps drained() honest
        self._pipeline = pipeline
        self._p1_queue: "queue.Queue" = queue.Queue()
        self._p1_outstanding = 0
        self._p1_thread = None
        if pipeline:
            self._p1_thread = threading.Thread(
                target=self._p1_collector, daemon=True, name="pass1-collect")
            self._p1_thread.start()
        # async VAD-decide lane: the posterior fetch (a device sync) +
        # automatons + splitter on a FIFO worker
        self._vad_async = vad_async
        self._vd_queue: "queue.Queue" = queue.Queue()
        self._vd_outstanding = 0
        # publishes one VAD batch's decisions (p1 groups + segments for
        # ALL slots) atomically wrt the tick's staging scan, so each
        # pass-1 step carries a full batch instead of fragments
        self._stage_lock = threading.Lock()
        # fused-tick async decide: the automaton + splitter pass over the
        # already-fetched posteriors runs on the decide lane during the
        # next tick's fetch wait
        self._decide_async = decide_async and fused_fetch
        self._vd_thread = None
        if vad_async or self._decide_async:
            self._vd_thread = threading.Thread(
                target=self._vd_collector, daemon=True, name="vad-decide")
            self._vd_thread.start()
        # upload double-buffer: the fused tick stages + uploads tick N+1's
        # int16 waves on a lane while tick N's combined fetch is in
        # flight. Staged work counts in the slots' vd_inflight from STAGE
        # time, so a slot is never reclaimed between staging and dispatch
        self._upload_overlap = upload_overlap and fused_fetch
        self._staged_next = None
        self._upload_pool = None
        if self._upload_overlap:
            import concurrent.futures

            self._upload_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="upload-lane")

    @torch.inference_mode()
    def warm_pass2_ring(self, buckets=(64, 128, 256),
                        batches=(1, 2, 4, 8, 16)):
        """Run the pass-2 ring front-end once for every (bucket, batch)
        the lane can take from the ring, then one pass-2 forward (the
        Paraformer's or SenseVoice's) at the largest of them: its first
        use of the attention library (the kernel build on the card) lands
        here, not on a live segment. Under a fan-out the forward runs on
        every rank."""
        if self.offline is None:
            return
        asr = self.offline.asr
        fcfg = asr.cfg.frontend
        means, vars_ = asr.cmvn
        feats, top = None, 0
        for bucket in buckets:
            if sf.offline_window_samples(fcfg, bucket) > self._ring_samples:
                continue
            for bb in batches:
                feats = sf.ring_frontend_device(
                    self._audio_ring, [0] * bb, [0] * bb, [1] * bb,
                    bucket, fcfg, means, vars_, batch_b=bb)
            top = bucket
        if feats is not None:
            out = asr.forward_feats(feats[:1], [top])
            to_host([out.logits[:1, :1, :1]])

    @torch.inference_mode()
    def warmup(self):
        """One step of each path before serving traffic (allocator, cuBLAS
        and library set-up off the live tick), and one work item through
        each async lane."""
        m = self.models
        c = self.capacity
        zi = to_device(self.device, np.zeros((8, c), np.int64))
        probs, _, _ = self._vad_step(
            m.vad_params, self._vad_means, self._vad_vars,
            torch.zeros((c, self._vad_max_new), dtype=torch.int16,
                        device=self.device),
            zi[0], zi[1], zi[2], zi[3], zi[4], self._vad_hist,
            self.vad_caches, self._audio_ring, zi[5], zi[6], zi[7])
        zp = to_device(self.device, np.zeros((10, c), np.int64))
        _, ids, nums, _ = self._p1_step(
            self.oparams, self._asr_means, self._asr_vars,
            self.online_state, self._audio_ring, *zp,
            self._p1_hist, self._p1_ring)
        if self._fused_fetch:
            to_host([probs, ids, nums])
        if self._upload_overlap:
            self._upload_pool.submit(self._upload_waves,
                                     np.zeros((1, 1), np.int16)).result()
        if self._vad_async:
            with self._results_lock:
                self._vd_outstanding += 1
            self._vd_queue.put((probs, []))          # fetch, no slots
        if self._pipeline:
            with self._results_lock:
                self._p1_outstanding += 1
            self._p1_queue.put(([], np.zeros(c, bool), ids, nums,
                                np.zeros(c, np.int64)))
        dummy = None
        if self._p2_thread is not None and self.offline is not None:
            # one segment through the pass-2 lane off the serving path
            dummy = _Slot()
            dummy.p2_inflight = 1
            self._p2_queue.put((-1, dummy, AudioFrame(
                data=np.zeros(3200, np.float32), is_final=True)))
        deadline = time.time() + 600
        while ((self._vd_outstanding > 0 or self._p1_outstanding > 0
                or (dummy is not None and dummy.p2_inflight > 0))
               and time.time() < deadline):
            time.sleep(0.01)

    # -- stream lifecycle ------------------------------------------------
    def open(self, hw_emb=None, hotwords=None, use_itn: bool = True,
             svs_lang=None, svs_itn=None, vad_tail_sil=None,
             vad_max_len=None, speech_noise_thres=None, mode=None) -> int:
        """Claim a slot with this connection's first-message options (the
        reference supports hotwords and per-request VAD/ITN/svs config on
        every connection, websocket-server-2pass.cpp:424-523). `mode` is
        the connection's: "2pass" (the engine's default) or "online",
        which gets pass-1 results labelled "online" and no pass 2.
        `hw_emb` (ServerModels.compile_hotwords' [N, D]) biases a
        Paraformer pass 2 and must match its hotword block; a SenseVoice
        pass 2 ignores it and biases with a context graph of `hotwords`
        instead, and takes svs_lang/svs_itn (None: the recognizer's)."""
        mode = mode or self.mode
        if mode not in ("2pass", "online") or (
                mode == "2pass" and self.offline is None):
            raise ValueError(f"an engine in mode {self.mode!r} cannot serve "
                             f"a {mode!r} stream")
        svs = (self.offline is not None
               and isinstance(self.offline.asr, SenseVoiceOffline))
        if hw_emb is not None and self.offline is not None and not svs:
            self._check_hw_emb(hw_emb)
        svs_context = (self.models.svs_context_graph(hotwords)
                       if svs and hotwords else None)
        lm_decoder = None
        if mode == "2pass" and self.models.has_lm:
            lm_decoder = (self.models._svs_lm_decoder(hotwords or None)
                          if svs else self.models._make_lm_decoder(
                              hotwords or None))
        with self._results_lock:
            # the reclaim check and the claim are one step: the staging
            # scan counts a slot's work under the same lock
            for sid, slot in enumerate(self.slots):
                if (not slot.active and slot.p1_inflight == 0
                        and slot.p2_inflight == 0 and slot.vd_inflight == 0):
                    # reclaim is deferred while the previous connection
                    # still has work in the async lanes — those lanes hold
                    # the OLD slot object, whose counters gate this branch
                    self._reset_slot(sid)
                    slot = self.slots[sid]
                    slot.active = True
                    slot.mode = mode
                    slot.use_itn = use_itn
                    slot.hw_emb = hw_emb
                    slot.svs_lang = svs_lang
                    slot.svs_itn = svs_itn
                    # compiled once per connection, shared read-only
                    slot.svs_context = svs_context
                    slot.lm_decoder = lm_decoder
                    slot.vad_tail_sil = vad_tail_sil
                    slot.vad_max_len = vad_max_len
                    slot.speech_noise_thres = speech_noise_thres
                    return sid
        self.models.release_lm_decoder(lm_decoder)
        raise EngineAtCapacity(
            f"engine at capacity ({self.capacity} streams)")

    def _check_hw_emb(self, hw_emb):
        """Raise unless hw_emb is an [N, D] embedding matrix that the
        Paraformer pass 2's hotword block takes: without the block, or at
        another width, the embeddings could only be dropped or fail in
        the pass-2 lane."""
        asr = self.offline.asr
        d = asr.cfg.encoder.output_size
        if asr.model.decoder.hotword is None:
            raise ValueError("hotword embeddings given, but the pass-2 "
                             "model has no hotword block")
        if np.ndim(hw_emb) != 2 or np.shape(hw_emb)[1] != d:
            raise ValueError(f"hotword embeddings {np.shape(hw_emb)} are "
                             f"not [N, {d}]")

    def _reset_slot(self, sid: int):
        m = self.models
        vmeans, vvars = (m.vad_cmvn if m.vad_cmvn is not None
                         else (None, None))
        # the previous connection's native automaton and LM decoder are
        # freed here: open() reclaims a slot only once no lane holds work
        # of it
        self._free_native(self.slots[sid])
        self.slots[sid] = _Slot(
            gen=self.slots[sid].gen + 1,
            vad_frontend=sf.StreamingFrontend(m.vad_cfg.frontend, vmeans,
                                              vvars, device=self.device),
            # the automaton takes the VAD config's options, as
            # FsmnVadStream does, and one column: the device-summed
            # silence posterior
            sm=E2EVadStateMachine(vad_options(m.vad_cfg, sil_pdf_ids=(0,))),
            splitter=TwoPassSplitter(m.vad_cfg.sample_rate),
            vocab=Vocab(m.vocab.tokens, m.vocab.lang),
            punc_cache=[],
        )
        # zero the batched device state for this slot
        self._clear_device_slot(sid)

    @torch.inference_mode()
    def _clear_p1_device(self, sids):
        """Zero the pass-1 device columns (online model caches + mel
        history) of one OR MANY slots in one batched update per tensor, so
        the ring-overrun quarantine costs a fixed set of launches however
        many slots overran. Used on slot reclaim AND on quarantine.

        In place is safe: these tensors are read only by later steps,
        which the tick thread enqueues after this on the same stream; the
        pass-1 collector (pipeline tick) and the fused fetch read only a
        step's ids and counts, fresh tensors no update touches."""
        if not isinstance(sids, (list, tuple)):
            sids = [sids]
        if not sids:
            return
        idx = torch.tensor(sids, dtype=torch.long).to(self.device)
        s = self.online_state
        for x in (s.feats_cache, s.pos, s.cif_integrate, s.cif_frame,
                  self._p1_hist):
            x.index_fill_(0, idx, 0)
        s.dec_caches.index_fill_(1, idx, 0)

    @torch.inference_mode()
    def _clear_device_slot(self, sid: int):
        self._clear_p1_device([sid])
        for c in self.vad_caches:
            c[sid] = 0
        self._vad_hist[sid] = 0
        self._vad_total[sid] = 0
        self._vad_next[sid] = 0
        self._abs_fed[sid] = 0
        # audio-ring and pending-ring contents are gated by the slot's
        # (reset) counters — stale samples and rows are never gathered

    def close(self, sid: int):
        self.slots[sid].active = False

    def feed(self, sid: int, samples: np.ndarray, is_final: bool = False):
        # PCM-grid quantization at the boundary (a no-op for real s16le
        # input) lets both fused steps stage int16 uploads bit-exactly
        self.slots[sid].audio_in.append((quantize_pcm(samples), is_final))

    def poll(self, sid: int) -> List[dict]:
        with self._results_lock:
            out = self.slots[sid].results
            self.slots[sid].results = []
        return out

    def drained(self, sid: int) -> bool:
        """True when every queued sample/frame/segment of this stream has
        produced its results (incl. segments in the async pass-2 lane)."""
        slot = self.slots[sid]
        return (not slot.audio_in
                and not slot.p1_groups
                and slot.p1_ring_w == slot.p1_ring_r
                and slot.p1_flush_at is None
                and not slot.seg_queue
                and slot.p2_inflight == 0
                and slot.p1_inflight == 0
                and slot.vd_inflight == 0)

    # -- the batched tick ------------------------------------------------
    def step(self):
        """One tick:
             1. stage + dispatch the fused VAD step
             2. VAD posterior fetch + automatons + splitter — on the
                vad-decide lane when vad_async, else inline
             3. dispatch this tick's pass-1 batch — fetched + detokenized
                on the collector thread when pipelined
             4. hand segments to the pass-2 lane
        """
        if self._fused_fetch:
            return self._step_fused()
        with METRICS.stage("tick_vad_dispatch"):
            ctx = self._vad_stage_dispatch()
        if self._vad_async:
            if ctx is not None:
                with self._results_lock:
                    for _, slot, _, _, _ in ctx[1]:
                        slot.vd_inflight += 1
                    self._vd_outstanding += 1
                self._vd_queue.put(ctx)
        else:
            with METRICS.stage("tick_vad_decide"):
                self._vad_decide(ctx)
        with METRICS.stage("tick_p1_dispatch"):
            self._asr_step()
        with METRICS.stage("tick_pass2_handoff"):
            self._pass2()

    def _step_fused(self):
        """Single-fetch tick: dispatch VAD_N, dispatch P1_N (staged from
        tick N-1's decisions), then ONE copy to the host for everything
        the host needs (the tick's only synchronisation); decisions and
        detokenization run after it."""
        overlap = self._upload_overlap
        with METRICS.stage("tick_vad_dispatch"):
            if overlap:
                # consume the upload lane's pre-staged (already-uploaded)
                # buffer; an unprimed pipeline stages inline this once
                staged = self._staged_next
                self._staged_next = None
                if staged is None:
                    staged = self._vad_stage_host(count_staged=True)
                ctx = (self._vad_dispatch_staged(staged)
                       if staged is not None else None)
            else:
                ctx = self._vad_stage_dispatch()
        with METRICS.stage("tick_p1_dispatch"):
            batches = self._asr_step(defer=True)
        upload_fut = None
        if overlap:
            # stage + upload the NEXT tick's waves while this tick's
            # combined fetch is in flight
            upload_fut = self._upload_pool.submit(self._stage_and_upload)
        handles = [] if ctx is None else [ctx[0]]
        for b in batches:
            handles.append(b[2])
            handles.append(b[3])
        try:
            with METRICS.stage("tick_fused_fetch"):
                fetched = to_host(handles)
            i = 0
            if ctx is not None:
                if self._decide_async:
                    # hand the (numpy) posteriors to the decide lane;
                    # counted accounting holds the slots' reclaim gate
                    # until the lane settles each work item
                    with self._results_lock:
                        if not overlap:   # overlap counted at stage time
                            for _, slot, _, _, _ in ctx[1]:
                                slot.vd_inflight += 1
                        self._vd_outstanding += 1
                    self._vd_queue.put((fetched[0], ctx[1]))
                else:
                    with METRICS.stage("tick_vad_decide"):
                        self._decide_counted(fetched[0], ctx[1], overlap)
                i = 1
            with METRICS.stage("tick_p1_detok"):
                for refs, finals, _, _, ends in batches:
                    self._finish_asr_batch(
                        (refs, finals, fetched[i], fetched[i + 1], ends),
                        inflight_counted=False)
                    i += 2
            with METRICS.stage("tick_pass2_handoff"):
                self._pass2()
        except BaseException:
            # the next tick needs the staged buffer even when this tick
            # failed (a lost future would leak its slots' vd_inflight
            # counts and wedge reclaim); an upload failure now is logged,
            # not raised over the tick's own exception
            if upload_fut is not None:
                try:
                    self._staged_next = upload_fut.result()
                except Exception:
                    log.exception("upload lane failure in a failed tick")
            raise
        if upload_fut is not None:
            with METRICS.stage("tick_upload_join"):
                self._staged_next = upload_fut.result()

    def _decide_counted(self, probs, work, counted: bool):
        """Inline decide with the counted-settlement contract: on a
        partial failure only the un-settled work items are decremented
        (the _vd_collector rule, applied to the fused tick)."""
        if not counted:
            return self._vad_decide((probs, work))
        settled: list = []
        try:
            self._vad_decide((probs, work), counted=True, settled=settled)
        except Exception:
            done = {id(s) for s in settled}
            with self._results_lock:
                for _, slot, _, _, _ in work:
                    if id(slot) not in done:
                        slot.vd_inflight -= 1
            raise

    def has_inflight(self) -> bool:
        return (self._p1_outstanding > 0 or self._vd_outstanding > 0
                or self._staged_next is not None)

    def slot_has_work(self, slot) -> bool:
        """True when a slot has queued audio/frames/segments a step() would
        advance (the serving loop's wake condition)."""
        return bool(slot.active
                    and (slot.audio_in or slot.p1_groups
                         or slot.p1_flush_at is not None
                         or slot.p1_ring_w - slot.p1_ring_r >= self.center
                         or slot.seg_queue))

    def _vad_stage_dispatch(self):
        staged = self._vad_stage_host()
        if staged is None:
            return None
        return self._vad_dispatch_staged(staged)

    def _upload_waves(self, waves: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(waves)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _stage_and_upload(self):
        """Upload-lane body: host-stage the next tick's audio and push
        the int16 waves to the device while the current tick's fetch is
        in flight. Staged work was counted into vd_inflight, so the
        decide path must run with counted=True."""
        staged = self._vad_stage_host(count_staged=True)
        if staged is not None:
            try:
                staged["dev_waves"] = self._upload_waves(staged["waves"])
            except Exception:
                # settle the counts a failed upload would otherwise leak
                with self._results_lock:
                    for _, slot, _, _, _ in staged["work"]:
                        slot.vd_inflight -= 1
                raise
        return staged

    def _vad_stage_host(self, count_staged: bool = False):
        m = self.models
        # stage every slot's VAD front-end for ONE fused device step;
        # consume at most one VAD bucket of audio per slot per step — a
        # burst-feeding client (whole file then is_speaking:false) must
        # not overflow the fixed [capacity, _vad_bucket] feature batch;
        # leftovers stay queued and later steps drain them
        staged = []  # (sid, slot, samples, is_final, buf, n_frames)
        fcfg = m.vad_cfg.frontend
        max_samples = 64 * fcfg.frame_shift * fcfg.lfr_n  # 0.64 s >= one chunk tick
        for sid, slot in enumerate(self.slots):
            if not slot.active or not slot.audio_in:
                continue
            if count_staged:
                # counted BEFORE the slot's audio is taken, under the lock
                # open() claims under: a slot with staged work is never
                # reclaimed, so its row cannot write this connection's
                # audio into a fresh connection's device columns
                with self._results_lock:
                    if self.slots[sid] is not slot or not slot.active:
                        continue
                    slot.vd_inflight += 1
            datas, total, is_final = [], 0, False
            # cap so the device ring write never passes the ring end;
            # leftovers re-queue for the next tick
            cap_samples = min(
                max_samples,
                self._ring_samples
                - int(self._abs_fed[sid]) % self._ring_samples)
            while slot.audio_in and total < cap_samples:
                s, f = slot.audio_in.pop(0)
                take = min(len(s), cap_samples - total)
                if take < len(s):
                    slot.audio_in.insert(0, (s[take:], f))
                    s, f = s[:take], False
                datas.append(s)
                total += len(s)
                is_final = is_final or f
            samples = (np.concatenate(datas) if datas
                       else np.zeros(0, np.float32))
            buf, nf = slot.vad_frontend.stage(samples)
            staged.append((sid, slot, samples, is_final, buf, nf))
        if not staged:
            return None
        lfr_m, lfr_n = fcfg.lfr_m, fcfg.lfr_n
        left = (lfr_m - 1) // 2
        waves = np.zeros((self.capacity, self._vad_max_new), np.int16)
        # rows: n_new, win_start, total_new, k_emit, finals, ring_off,
        # n_samp, win_off
        ints = np.zeros((8, self.capacity), np.int64)
        ints[1] = self._vad_next
        ints[2] = self._vad_total
        work = []  # (sid, slot, samples, is_final, n_vad_rows)
        for sid, slot, samples, is_final, buf, nf in staged:
            # ONLY the new samples upload (exact: PCM-grid float k/32768,
            # so *32768 is integer); the fbank window — the frontend's
            # framing residual followed by these samples — is re-read
            # from the device ring inside the step
            n = len(samples)
            waves[sid, :n] = (samples * 32768.0).astype(np.int16)
            ints[5, sid] = self._abs_fed[sid] % self._ring_samples
            ints[7, sid] = ((self._abs_fed[sid] - (len(buf) - n))
                            % self._ring_samples)
            ints[6, sid] = n
            self._abs_fed[sid] += n
            ints[0, sid] = nf
            total = int(self._vad_total[sid]) + nf
            ints[2, sid] = total
            if is_final:
                upto = -(-total // lfr_n)
            else:
                upto = max((total - 1 - (lfr_m - 1) + left) // lfr_n + 1, 0)
            upto = max(upto, int(self._vad_next[sid]))
            ints[3, sid] = upto - self._vad_next[sid]
            if is_final:
                self._vad_total[sid] = 0
                self._vad_next[sid] = 0
                slot.vad_frontend.reset()  # drop residual
                ints[4, sid] = 1
            else:
                self._vad_total[sid] = total
                self._vad_next[sid] = upto
            work.append((sid, slot, samples, is_final, int(ints[3, sid])))
        return {"waves": waves, "ints": ints, "work": work,
                "dev_waves": None}

    @torch.inference_mode()
    def _vad_dispatch_staged(self, staged):
        m = self.models
        dev_waves = staged["dev_waves"]
        if dev_waves is None:
            dev_waves = self._upload_waves(staged["waves"])
        (n_new, win_start, total_new, k_emit, finals, ring_off, n_samp,
         win_off) = to_device(self.device, staged["ints"])
        probs, self._vad_hist, self.vad_caches = self._vad_step(
            m.vad_params, self._vad_means, self._vad_vars, dev_waves,
            n_new, win_start, total_new, k_emit, finals, self._vad_hist,
            self.vad_caches, self._audio_ring, ring_off, n_samp, win_off)
        # dispatched; the posterior fetch happens in _vad_decide or in
        # the fused tick's combined fetch
        return probs, staged["work"]

    def _vd_collector(self):
        """Async VAD-decide lane: a single FIFO worker (per-slot decision
        order preserved) fetches each dispatched posterior batch and runs
        the automatons + splitter, feeding the pass-1 groups and pass-2
        segment queues the tick consumes."""
        while True:
            ctx = self._vd_queue.get()
            if ctx is None:
                return
            settled: list = []
            try:
                self._vad_decide(ctx, counted=True, settled=settled)
            except Exception:  # pragma: no cover - keep the lane alive
                log.exception("vad-decide lane failure")
                # decrement ONLY the work items _vad_decide had not
                # already settled (decrementing them again drives
                # vd_inflight negative and open()'s reclaim gate never
                # passes — a permanent slot leak)
                done = {id(s) for s in settled}
                with self._results_lock:
                    for _, slot, _, _, _ in ctx[1]:
                        if id(slot) not in done:
                            slot.vd_inflight -= 1
            finally:
                with self._results_lock:
                    self._vd_outstanding -= 1

    def _vad_decide(self, ctx, counted: bool = False, settled=None):
        if ctx is None:
            return
        if settled is None:
            settled = []
        probs, work = ctx
        m = self.models
        if isinstance(probs, torch.Tensor):
            with METRICS.stage("vd_probs_fetch"):
                probs = to_host([probs])[0]
        # VAD decisions + 2pass split per slot (host, O(frames)); collect
        # the online frames into per-slot groups split at final flags so
        # the ASR front-ends batch the same way
        t_sm = time.perf_counter()
        publishes = []
        for sid, slot, samples, is_final, n in work:
            if self.slots[sid] is not slot:
                # connection replaced since dispatch: drop the decision
                # (captured-object rule)
                if counted:
                    with self._results_lock:
                        slot.vd_inflight -= 1
                    settled.append(slot)
                continue
            # probs here is the device-summed sil posterior [nf]; the slot
            # automaton takes one column (sil_pdf_ids (0,))
            events = slot.sm(
                probs[sid, :n, None], samples, is_final=is_final, online=True,
                max_end_sil=(slot.vad_tail_sil if slot.vad_tail_sil
                             is not None else m.vad_cfg.max_end_silence_time),
                max_single_segment_time=(
                    slot.vad_max_len if slot.vad_max_len is not None
                    else m.vad_cfg.max_single_segment_time),
                speech_noise_thres=(
                    slot.speech_noise_thres
                    if slot.speech_noise_thres is not None
                    else m.vad_cfg.speech_noise_thres),
            )
            online_frames, offline_frames = slot.splitter.feed(
                samples, events, self.chunk_len, slot.mode)
            # offline frames' epoch-sample ranges to GLOBAL absolute
            # coordinates NOW (splitter_base moves on utterance finals;
            # the pass-2 lane gathers these from the device ring later)
            for fr in offline_frames:
                if fr.samp_start >= 0:
                    fr.samp_start += slot.splitter_base
                    fr.samp_end += slot.splitter_base
            # online speech as ABSOLUTE sample ranges into the device
            # audio ring: consecutive frames of one utterance are
            # contiguous in the fed stream, so a group is (abs_start,
            # n_samples, final). Frame positions are splitter-epoch ms;
            # align to the end (the splitter clamps only the front)
            gs, cur_start, cur_n = [], None, 0
            seg_sample = slot.splitter.seg_sample   # samples per ms
            for fr in online_frames:
                n = len(fr.data)
                if cur_start is None:
                    cur_start = (slot.splitter_base
                                 + fr.global_end * seg_sample - n)
                cur_n += n
                if fr.is_final:
                    gs.append((cur_start, cur_n, True))
                    cur_start, cur_n = None, 0
            if cur_n:
                gs.append((cur_start, cur_n, False))
            slot.vd_abs += len(samples)
            publishes.append((slot, gs, offline_frames))
            if is_final:
                slot.splitter.reset()
                slot.splitter_base = slot.vd_abs
        # route the speech to the fused pass-1 lane. The whole batch
        # publishes ATOMICALLY wrt the tick's staging scan, so a
        # concurrent _asr_step stages all-or-none of this batch and the
        # pass-1 step stays one full batch per chunk cadence
        with self._stage_lock:
            for slot, gs, offline_frames in publishes:
                slot.seg_queue.extend(offline_frames)
                slot.p1_groups.extend(gs)
        if counted:
            with self._results_lock:
                for slot, _, _ in publishes:
                    slot.vd_inflight -= 1
                    settled.append(slot)
        METRICS.add_stage("vd_automaton", time.perf_counter() - t_sm)

    @torch.inference_mode()
    def _asr_step(self, defer: bool = False):
        """Stage + dispatch pass-1 rounds. With defer=True (fused-fetch
        tick) the dispatched batches are returned with their device
        handles instead of being fetched here or handed to the
        collector."""
        deferred = []
        if self.mode == "offline":
            return deferred
        c = self.center
        cap = self.capacity
        fcfg = self.ocfg.frontend
        shift, flen = fcfg.frame_shift, fcfg.frame_length
        lfr_m, lfr_n = fcfg.lfr_m, fcfg.lfr_n
        left = (lfr_m - 1) // 2
        # the samples an LFR row needs past its first frame's start: its
        # last tap's frame, (lfr_m - 1 - left) frames on, whole
        row_reach = (lfr_m - 1 - left) * shift + flen
        ring_n = self._p1_ring_n
        # stage at most one VAD-tick's worth of samples per slot per round
        # so k_emit stays within the step's k_max window budget
        max_stage = (self._p1_kmax - 2) * lfr_n * shift
        for _round in range(8):
            # rows: start_off, n_new, win_start, total_new, k_emit,
            # fe_finals, ring_woff, consume_start, consume_count, finals
            ints = np.zeros((10, cap), np.int64)
            (start_off, n_new, win_start, total_new, k_emit, fe_finals,
             ring_woff, consume_start, consume_count, finals) = ints
            # per consumed slot, the stream's sample count the chunk's
            # audio ends at (the last row's taps, or the utterance's end)
            ends = np.zeros(cap, np.int64)
            todo = []
            quarantined = []
            more = False
            # staging scan under the publish lock: a mid-publish VAD
            # batch is invisible, so each pass-1 step carries a FULL
            # batch of chunks instead of fragments
            with self._stage_lock:
                for sid, slot in enumerate(self.slots):
                    if not slot.active:
                        continue
                    if slot.p1_groups and slot.p1_flush_at is None:
                        if self._quarantine_overrun(sid, slot):
                            quarantined.append(sid)
                            ring_woff[sid] = slot.p1_ring_w % ring_n
                            continue
                        # ---- stage new speech samples (up to one
                        # utterance final); while a final's windows are
                        # still draining from the ring, staging pauses so
                        # the flush boundary (p1_flush_at) is unambiguous
                        total, fe_fin = 0, False
                        while (slot.p1_groups and total < max_stage
                               and not fe_fin):
                            g_start, g_n, f = slot.p1_groups.pop(0)
                            take = min(g_n, max_stage - total)
                            if take < g_n:
                                slot.p1_groups.insert(
                                    0, (g_start + take, g_n - take, f))
                                g_n, f = take, False
                            if slot.p1_residual == 0 and total == 0:
                                # fresh utterance (or stream start): the
                                # staged range begins at this group
                                slot.p1_cursor = g_start
                                slot.p1_utt_start = g_start
                                slot.p1_utt_rows = 0
                            total += g_n
                            fe_fin = fe_fin or f
                        lbuf = slot.p1_residual + total
                        n = ((lbuf - flen) // shift + 1
                             if lbuf >= flen else 0)
                        start_off[sid] = slot.p1_cursor % self._ring_samples
                        if fe_fin:
                            slot.p1_utt_end = slot.p1_cursor + lbuf
                        slot.p1_cursor += n * shift
                        slot.p1_residual = 0 if fe_fin else lbuf - n * shift
                        n_new[sid] = n
                        tot = slot.p1_total + n
                        win_start[sid] = slot.p1_win
                        total_new[sid] = tot
                        if fe_fin:
                            upto = -(-tot // lfr_n)
                        else:
                            upto = max(
                                (tot - 1 - (lfr_m - 1) + left) // lfr_n + 1,
                                slot.p1_win)
                        k_emit[sid] = upto - slot.p1_win
                        # the +2 window margin in k_max only covers lfr
                        # geometries with ceil((lfr_m-1-left)/lfr_n) <= 2
                        if k_emit[sid] > self._p1_kmax:
                            raise RuntimeError(
                                f"pass-1 k_emit {int(k_emit[sid])} exceeds "
                                f"the step's window budget {self._p1_kmax}; "
                                f"the frontend lfr geometry (m={lfr_m}, "
                                f"n={lfr_n}) is incompatible with "
                                "_P1_FRAMES staging")
                        ring_woff[sid] = slot.p1_ring_w % ring_n
                        slot.p1_ring_w += upto - slot.p1_win
                        if fe_fin:
                            fe_finals[sid] = 1
                            slot.p1_total = 0
                            slot.p1_win = 0
                            slot.p1_flush_at = slot.p1_ring_w
                        else:
                            slot.p1_total = tot
                            slot.p1_win = upto
                    else:
                        # window accounting still needs sane values
                        win_start[sid] = slot.p1_win
                        total_new[sid] = slot.p1_total
                        ring_woff[sid] = slot.p1_ring_w % ring_n
                    # ---- consume one chunk (exact center rows, or the
                    # final partial once the utterance's windows are all
                    # in the ring)
                    cnt = 0
                    pending = slot.p1_ring_w - slot.p1_ring_r
                    if slot.p1_flush_at is not None:
                        pend_old = slot.p1_flush_at - slot.p1_ring_r
                        if pend_old <= c:
                            cnt = pend_old
                            finals[sid] = 1
                            slot.p1_flush_at = None
                        else:
                            cnt = c
                    elif pending >= c:
                        cnt = c
                    if cnt or finals[sid]:
                        consume_start[sid] = slot.p1_ring_r % ring_n
                        consume_count[sid] = cnt
                        slot.p1_ring_r += cnt
                        slot.p1_utt_rows += cnt
                        ends[sid] = (slot.p1_utt_end if finals[sid] else
                                     slot.p1_utt_start + row_reach
                                     + (slot.p1_utt_rows - 1) * lfr_n * shift)
                        todo.append(sid)
                    if (slot.p1_groups or slot.p1_flush_at is not None
                            or slot.p1_ring_w - slot.p1_ring_r >= c):
                        more = True
            self._clear_p1_device(quarantined)
            if not todo and not n_new.any():
                return deferred
            (self.online_state, ids, nums,
             self._p1_hist) = self._p1_step(
                self.oparams, self._asr_means, self._asr_vars,
                self.online_state, self._audio_ring,
                *to_device(self.device, ints), self._p1_hist, self._p1_ring)
            # the step computes every slot's row; `active` of them advance
            METRICS.count("engine.p1_steps")
            METRICS.count("engine.p1_rows", cap)
            METRICS.count("engine.p1_active", len(todo))
            if todo:
                batch = ([(sid, self.slots[sid]) for sid in todo],
                         finals.astype(bool), ids, nums, ends)
                if defer:
                    deferred.append(batch)
                elif self._pipeline:
                    # hand the in-flight batch to the collector thread: its
                    # fetch + detok never block the tick
                    with self._results_lock:
                        for sid in todo:
                            self.slots[sid].p1_inflight += 1
                        self._p1_outstanding += 1
                    self._p1_queue.put(batch)
                else:
                    self._finish_asr_batch(batch, inflight_counted=False)
            if not more:
                return deferred
        return deferred

    def _quarantine_overrun(self, sid: int, slot) -> bool:
        """Ring-age guard, checked BEFORE any state mutation: if this
        slot's pass-1 backlog outran the device audio ring (its oldest
        staged sample was overwritten), drop THIS stream's pass-1 backlog
        and tell the caller to clear its device columns (batched, after
        the scan). Raising instead would abort the shared scan after
        earlier slots advanced their mirrors, and the server loop's
        containment would retry into the same error every tick."""
        oldest = (slot.p1_cursor if slot.p1_residual
                  else slot.p1_groups[0][0])
        if self._abs_fed[sid] - oldest <= self._ring_samples - self._p1_need:
            return False
        log.error("slot %d pass-1 backlog exceeds the device audio ring "
                  "(%d samples); dropping its pass-1 backlog", sid,
                  self._ring_samples)
        slot.p1_groups.clear()
        slot.p1_residual = 0
        slot.p1_total = 0
        slot.p1_win = 0
        slot.p1_flush_at = None
        slot.p1_ring_r = slot.p1_ring_w
        # the device columns and the streaming detok no longer correspond
        # to any staged audio: the NEXT utterance decodes from clean state
        slot.vocab.reset_streaming()
        return True

    def shutdown(self, timeout: float = 10.0):
        """Drain and join the background lanes."""
        if self._vd_thread is not None:
            self._vd_queue.put(None)
            self._vd_thread.join(timeout)
            self._vd_thread = None
        if self._p1_thread is not None:
            self._p1_queue.put(None)
            self._p1_thread.join(timeout)
            self._p1_thread = None
        if self._p2_thread is not None:
            self._p2_queue.put(None)
            self._p2_thread.join(timeout)
            self._p2_thread = None
        if self._upload_pool is not None:
            self._upload_pool.shutdown(wait=True)
            self._upload_pool = None
        # free every slot's native automaton and LM decoder; a tick still
        # running in another thread gets an error from a freed one, not
        # freed memory
        for slot in self.slots:
            self._free_native(slot)

    def _free_native(self, slot):
        if slot.sm is not None:
            slot.sm.close()
        self.models.release_lm_decoder(slot.lm_decoder)
        slot.lm_decoder = None

    def _p1_collector(self):
        """Background pass-1 result lane: a single FIFO worker (per-slot
        result order preserved) fetches each dispatched batch and posts
        partial texts to the slots."""
        while True:
            batch = self._p1_queue.get()
            if batch is None:
                return
            try:
                self._finish_asr_batch(batch, inflight_counted=True)
            except Exception:  # pragma: no cover - keep the lane alive
                log.exception("pass-1 collector failure")
                with self._results_lock:
                    for _, slot in batch[0]:
                        slot.p1_inflight -= 1
            finally:
                with self._results_lock:
                    self._p1_outstanding -= 1

    def _finish_asr_batch(self, batch, inflight_counted: bool):
        slot_refs, finals, ids, nums, ends = batch
        if isinstance(ids, torch.Tensor):
            ids, nums = to_host([ids, nums])  # one fetch, not two
        for sid, slot in slot_refs:
            k = int(nums[sid])
            if k:
                text = slot.vocab.to_string(
                    [int(x) for x in ids[sid, :k]], streaming=True)
                if text:
                    with self._results_lock:
                        # captured-object delivery: a reclaimed slot index
                        # never receives a previous connection's partial
                        if self.slots[sid] is slot:
                            slot.results.append(
                                {"mode": "2pass-online"
                                 if slot.mode == "2pass" else "online",
                                 "text": text,
                                 "end_sample": int(ends[sid])})
            if finals[sid]:
                # the front-end already reset itself on the final commit;
                # only detok state resets here
                slot.vocab.reset_streaming()
        if inflight_counted:
            with self._results_lock:
                for _, slot in slot_refs:
                    slot.p1_inflight -= 1

    def _pass2(self):
        if self.offline is None:
            return
        pairs = []
        for sid, slot in enumerate(self.slots):
            if not slot.active:
                # a closed connection's queued segments have no reader —
                # drop them instead of spending pass-2 compute
                slot.seg_queue.clear()
                continue
            while slot.seg_queue:
                fr = slot.seg_queue.pop(0)
                slot.p2_inflight += 1
                pairs.append((sid, slot, fr))
        if not pairs:
            return
        if self._p2_async:
            for p in pairs:
                self._p2_queue.put(p)
        else:
            self._process_segments(pairs)

    def _p2_worker(self):
        """Background pass-2 lane: drains segments in batches so pass-1
        ticks keep their ~600 ms cadence while long segments decode."""
        while True:
            first = self._p2_queue.get()
            if first is None:
                return
            pairs = [first]
            # greedy drain: recognize_batch buckets internally (chunks of
            # <= 16) and fetches once for all of them
            while len(pairs) < max(self.capacity, 16):
                try:
                    nxt = self._p2_queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._p2_queue.put(None)   # re-post the stop signal
                    break
                pairs.append(nxt)
            settled: list = []
            try:
                self._process_segments(pairs, settled)
            except Exception:  # pragma: no cover - keep the lane alive
                log.exception("pass-2 lane failure")
                # decrement ONLY the pairs _process_segments had not
                # already settled, on the CAPTURED slot objects
                done = set(settled)
                with self._results_lock:
                    for idx, (_, slot, _) in enumerate(pairs):
                        if idx not in done:
                            slot.p2_inflight -= 1

    def _ring_feats_override(self, pairs):
        """feats_override for the pass-2 recognizer: segments whose
        samples still live in the device audio ring are gathered there
        (no re-upload); anything stale, un-ranged or too long takes the
        int16 upload path.

        Freshness is re-checked AFTER the gather is enqueued: staging
        advances _abs_fed BEFORE it enqueues the ring write, and the
        device runs the default stream's work in enqueue order, so if the
        window still fits under the post-gather _abs_fed, no write that
        could precede the gather has overwritten it."""
        if self.mode == "online" or self.offline is None:
            return None
        asr = self.offline.asr
        fcfg = asr.cfg.frontend
        means, vars_ = asr.cmvn
        r = self._ring_samples
        margin = 16 * self._vad_max_new
        frames = [fr for _, _, fr in pairs]
        sids = [sid for sid, _, _ in pairs]

        def override(idxs, bucket, bb):
            need = sf.offline_window_samples(fcfg, bucket)
            if need > r - margin:
                return None
            slot_ids, offs, ns = [], [], []
            for i in idxs:
                fr = frames[i]
                sid = sids[i]
                if (fr.samp_start < 0
                        or fr.samp_end - fr.samp_start != len(fr.data)
                        or int(self._abs_fed[sid]) - fr.samp_start
                        > r - need - margin):
                    return None
                slot_ids.append(sid)
                offs.append(fr.samp_start)
                ns.append(num_frames(len(fr.data), fcfg))
            feats = sf.ring_frontend_device(self._audio_ring, slot_ids,
                                            offs, ns, bucket, fcfg, means,
                                            vars_, batch_b=bb)
            if feats is None:
                return None
            # post-dispatch freshness verification (see docstring)
            for i in idxs:
                if (int(self._abs_fed[sids[i]]) - frames[i].samp_start
                        > r - need):
                    return None
            return feats

        return override

    @torch.inference_mode()
    def _process_segments(self, pairs, settled=None):
        """Offline-decode segments with each owner's per-connection
        options (hotwords, LM decoder, svs language and ITN) and post
        results
        (punctuation, ITN, timestamps) to the slots that queued them.

        `settled` (when given) collects the pair indices whose inflight
        counter this call decremented — the caller's failure handler
        decrements only the remainder. Per-segment post-processing
        failures (punc/ITN/timestamps) are contained per pair so one bad
        segment cannot poison the whole batch."""
        if settled is None:
            settled = []
        slots = [slot for _, slot, _ in pairs]
        segs = [fr.data for _, _, fr in pairs]
        kw = {"feats_override": self._ring_feats_override(pairs)}
        if isinstance(self.offline.asr, SenseVoiceOffline):
            # per-slot language and ITN prefix ids, hotword context graphs
            kw.update(langs=[s.svs_lang for s in slots],
                      itn_flags=[s.svs_itn for s in slots],
                      contexts=[s.svs_context for s in slots])
        elif any(s.hw_emb is not None for s in slots):
            kw["hw_embs"] = [s.hw_emb for s in slots]
        if any(s.lm_decoder is not None for s in slots):
            kw["lm_decoders"] = [s.lm_decoder for s in slots]
        METRICS.count("engine.p2_segments", len(pairs))
        METRICS.count("engine.p2_audio_ms", sum(
            len(s) for s in segs) * 1000 // self.models.vad_cfg.sample_rate)
        with METRICS.stage("p2_recognize"):
            outs = self.offline.asr.recognize_batch(segs, **kw)
        t_post = time.perf_counter()
        for idx, ((text, merged), (sid, slot, fr)) in enumerate(
                zip(outs, pairs)):
            res = None
            try:
                stamps = ts_mod.stamps_to_ms(merged,
                                             fr.global_start / 1000.0)
                if self.punc is not None and text:
                    text = self.punc.add_punc_streaming(text,
                                                        slot.punc_cache)
                if self.models.itn is not None and slot.use_itn and text:
                    text_itn = self.models.itn.normalize(text)
                    if stamps:
                        sm = ts_mod.timestamp_smooth(text, text_itn,
                                                     stamps)
                        if sm:
                            stamps = sm
                    text = text_itn
                # the stream's sample count at the segment's end point
                res = {"mode": "2pass-offline", "text": text,
                       "end_sample": fr.samp_end}
                if stamps:
                    res["timestamp"] = stamps
                    res["stamp_sents"] = ts_mod.timestamp_sentence(text,
                                                                   stamps)
            except Exception:  # pragma: no cover - per-pair containment
                log.exception("pass-2 post-processing failure (slot %d)",
                              sid)
            with self._results_lock:
                slot.p2_inflight -= 1
                settled.append(idx)
                # deliver only to the connection that queued the segment:
                # a reclaimed (or closed) slot index drops the transcript
                if (res is not None and self.slots[sid] is slot
                        and slot.active):
                    slot.results.append(res)
        METRICS.add_stage("p2_postprocess", time.perf_counter() - t_post)
