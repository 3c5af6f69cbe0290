"""Per-stream VAD: streaming front-end -> FSMN net -> decision automaton.

Counterpart of the JAX package's runtime/vad_stream.py. The net runs on the
device over chunks padded to 25-frame buckets with its caches there; the
posteriors come back to the host once a chunk for the automaton.

The offline segmenter has the whole file, so its front-end and net run
on the device once a file (the net in blocks of at most _NET_ROWS rows,
its caches carried), and one copy brings the silence posterior to the
host. The automaton is still fed window by window, with each window's
samples and the rows a StreamingFrontend would have emitted for it
(window_rows): its energy frames are framed per call, so that keeps
every segment what the windowed stream gives.

Spans (runtime/metrics): vad.setup (the stream's, or the offline
segmenter's model and automaton), vad.frontend, vad.net and
vad.automaton, and vad.fetch around each blocking copy to the host.
FsmnVadStream: each once a chunk, and vad.fetch twice (the front-end's
mel rows, the net's posteriors). vad_segments_offline: vad.frontend and
vad.fetch once a file, vad.net once a block, vad.automaton around the
window loop; counters vad.windows and vad.net_calls.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import FrontendConfig, VadConfig
from asr2pass_tpu_torch.frontend.fbank import get_extractor, num_frames
from asr2pass_tpu_torch.models import fsmn_vad
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from asr2pass_tpu_torch.utils import fp32_products, resolve_device
from asr2pass_tpu_torch.vad.e2e_vad import E2EVadStateMachine, VadOptions

_BUCKET = 25
# LFR rows of one offline net call, and mel frames of one offline fbank
# slice (60 s): bounds the transient device memory of a long file
_NET_ROWS = 6000


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


def window_rows(n_samples: int, fcfg: FrontendConfig, step: int
                ) -> List[int]:
    """The LFR rows StreamingFrontend.accept emits for each `step`-sample
    window of an n_samples file, the last window final: a window emits
    the rows whose last tap has arrived, the final one up to
    ceil(mel frames / lfr_n). The frontend carries its residual samples,
    so after a window it holds num_frames of all the samples so far."""
    m, n = fcfg.lfr_m, fcfg.lfr_n
    left = (m - 1) // 2
    rows, done = [], 0
    for off in range(0, n_samples, step):
        end = off + step
        mel = num_frames(min(end, n_samples), fcfg)
        if end >= n_samples:
            upto = -(-mel // n)
        else:
            upto = (mel - 1 - (m - 1) + left) // n + 1
        rows.append(max(upto - done, 0))
        done = max(done, upto)
    return rows


def _offline_feats(samples: np.ndarray, fcfg: FrontendConfig, cmvn,
                   dev) -> torch.Tensor:
    """A whole file's LFR+CMVN rows [ceil(mel/lfr_n), lfr_dim] on the
    device, equal to StreamingFrontend's: fbank over the file's mel
    frames in slices of _NET_ROWS, the LFR taps clamped as apply_lfr
    clamps them (first-frame left pad, last-frame tail repeat)."""
    ex = get_extractor(fcfg)
    n_mel = num_frames(len(samples), fcfg)
    wave = torch.from_numpy(samples).to(dev) * fcfg.scale_input
    flen, shift = fcfg.frame_length, fcfg.frame_shift
    mel = torch.cat([
        ex.frames_to_mel(wave[f0 * shift: (min(f0 + _NET_ROWS, n_mel) - 1)
                              * shift + flen].unfold(0, flen, shift))
        for f0 in range(0, n_mel, _NET_ROWS)])
    m, n = fcfg.lfr_m, fcfg.lfr_n
    t_lfr = -(-n_mel // n)
    idx = (torch.arange(t_lfr, device=dev)[:, None] * n
           + torch.arange(m, device=dev)[None, :] - (m - 1) // 2)
    feats = mel[idx.clamp_(0, n_mel - 1)].reshape(t_lfr, fcfg.lfr_dim)
    # as StreamingFrontend: either half of the CMVN may be missing
    means, vars_ = cmvn if cmvn is not None else (None, None)
    means = (np.zeros(fcfg.lfr_dim, np.float32) if means is None
             else np.asarray(means, np.float32))
    vars_ = (np.ones(fcfg.lfr_dim, np.float32) if vars_ is None
             else np.asarray(vars_, np.float32))
    return (feats + torch.from_numpy(means).to(dev)) * torch.from_numpy(
        vars_).to(dev)


@torch.inference_mode()
def _offline_silence(model, cfg: VadConfig, samples: np.ndarray, cmvn,
                     total: int, dev) -> np.ndarray:
    """The summed silence posterior of a file's `total` LFR rows [total,
    1] on the host: the front-end once, the net in blocks of _NET_ROWS
    rows with its caches carried, one copy."""
    with METRICS.stage("vad.frontend"):
        feats = _offline_feats(samples, cfg.frontend, cmvn, dev)
    caches = fsmn_vad.init_caches(cfg, 1, dev)
    ids = list(cfg.sil_pdf_ids)
    cols = []
    for a in range(0, total, _NET_ROWS):
        with METRICS.stage("vad.net"):
            probs, caches = fsmn_vad.apply(
                model, feats[None, a: a + _NET_ROWS], caches)
            cols.append(probs[0, :, ids].sum(-1))
    METRICS.count("vad.net_calls", len(cols))
    with METRICS.stage("vad.fetch"):
        return torch.cat(cols).cpu().numpy()[:, None]


def vad_segments_offline(params, cfg: VadConfig, samples, cmvn=None,
                         window_s: float = 1.0, device="cuda",
                         max_end_sil: Optional[int] = None,
                         max_single_segment: Optional[int] = None,
                         speech_noise_thres: Optional[float] = None
                         ) -> List[List[int]]:
    """Offline long-audio segmentation: the online automaton fed fixed
    windows, its [s,-1]/[-1,e] events joined into closed [s,e] segments;
    the same segments as streaming the windows through FsmnVadStream.
    The overrides default to the config's, as FsmnVadStream's do."""
    with METRICS.stage("vad.setup"):
        dev = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            model = params.to(dev).eval().requires_grad_(False)
        else:
            model = fsmn_vad.from_state_dict(params, cfg, dev)
        # one column, the silence posterior already summed on the device
        sm = E2EVadStateMachine(vad_options(cfg, sil_pdf_ids=(0,)))
    try:
        samples = np.asarray(samples, np.float32)
        step = int(cfg.sample_rate * window_s)
        rows = window_rows(len(samples), cfg.frontend, step)
        METRICS.count("vad.windows", len(rows))
        total = sum(rows)
        sil = (_offline_silence(model, cfg, samples, cmvn, total, dev)
               if total else np.zeros((0, 1), np.float32))
        overrides = dict(
            max_end_sil=(cfg.max_end_silence_time if max_end_sil is None
                         else max_end_sil),
            max_single_segment_time=(cfg.max_single_segment_time
                                     if max_single_segment is None
                                     else max_single_segment),
            speech_noise_thres=(cfg.speech_noise_thres
                                if speech_noise_thres is None
                                else speech_noise_thres))
        events: List[List[int]] = []
        with METRICS.stage("vad.automaton"):
            r = 0
            for k, count in enumerate(rows):
                is_final = k == len(rows) - 1
                # as FsmnVadStream.accept: a window with no rows is skipped
                if count == 0 and not is_final:
                    continue
                events.extend(sm(sil[r: r + count],
                                 samples[k * step: (k + 1) * step],
                                 is_final=is_final, online=True,
                                 **overrides))
                r += count
    finally:
        sm.close()
    # merge events into closed segments
    out, start = [], -1
    for s, e in events:
        if s != -1:
            start = s
        if e != -1 and start != -1:
            out.append([start, e])
            start = -1
    return out
