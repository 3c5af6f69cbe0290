"""Front-end: samples -> fbank -> LFR -> CMVN features, chunk by chunk
and whole.

Counterpart of the JAX package's runtime/streaming_frontend.py:
StreamingFrontend (chunk-incremental, with exact offline parity),
offline_window_samples, the fused device front-end _frontend_feats /
offline_frontend_device (int16 upload, then fbank, LFR and CMVN on the
card), its ring variant ring_frontend_device (the engine's pass-2 lane)
and the one-shot reference offline_frontend.

StreamingFrontend keeps one invariant: the concatenation of its outputs
equals the offline front-end run on the same audio. Its state is the
residual samples, a trimmed mel ring and the emitted-window counter.
Fbank runs on the device over chunks padded to 25-frame buckets (exact:
each mel frame depends only on its own window); the mel rows come back
to the host, where the LFR windows and CMVN are emitted.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asr2pass_tpu_torch.config import FrontendConfig
from asr2pass_tpu_torch.frontend.audio import quantize_pcm
from asr2pass_tpu_torch.frontend.fbank import get_extractor, num_frames
from asr2pass_tpu_torch.frontend.lfr import apply_cmvn, apply_lfr
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.utils import resolve_device, to_device


_BUCKET = 25  # fbank frames per chunk bucket (250 ms)


class StreamingFrontend:
    """fetch_span: the runtime/metrics span around the copy of each
    chunk's mel rows to the host (None: no span)."""

    def __init__(self, cfg: FrontendConfig, cmvn_means=None, cmvn_vars=None,
                 device="cuda", fetch_span: Optional[str] = None):
        self.cfg = cfg
        self.fetch_span = fetch_span
        self.device = resolve_device(device)
        self.extractor = get_extractor(cfg)
        d = cfg.lfr_dim
        self.means = (np.zeros(d, np.float32) if cmvn_means is None
                      else np.asarray(cmvn_means, np.float32))
        self.vars = (np.ones(d, np.float32) if cmvn_vars is None
                     else np.asarray(cmvn_vars, np.float32))
        self.reset()

    def reset(self):
        self._residual = np.zeros(0, dtype=np.float32)
        self._mel: Optional[np.ndarray] = None   # trimmed buffer
        self._mel_base = 0                       # global index of _mel[0]
        self._mel_total = 0                      # total mel frames produced
        self._next_window = 0                    # next LFR window index

    # -- internals --------------------------------------------------------
    def _fbank_chunk(self, samples: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        n = num_frames(len(samples), cfg)
        if n == 0:
            return np.zeros((0, cfg.n_mels), np.float32)
        bucket = -(-n // _BUCKET) * _BUCKET
        need = cfg.frame_length + (bucket - 1) * cfg.frame_shift
        if len(samples) < need:
            samples = np.pad(samples, (0, need - len(samples)))
        mel = self.extractor(samples[:need], self.device)
        with METRICS.stage(self.fetch_span):
            return mel[:n].cpu().numpy()

    def _emit_windows(self, upto: int) -> np.ndarray:
        """Emit LFR windows [_next_window, upto); taps past the last mel
        frame repeat it (the offline tail padding)."""
        cfg = self.cfg
        left = (cfg.lfr_m - 1) // 2
        count = upto - self._next_window
        if count <= 0 or self._mel is None or self._mel_total == 0:
            return np.zeros((0, cfg.lfr_dim), np.float32)
        wins = np.arange(self._next_window, upto)[:, None]
        idx = wins * cfg.lfr_n + np.arange(cfg.lfr_m)[None, :] - left
        idx = np.clip(idx, 0, self._mel_total - 1)
        feats = self._mel[idx - self._mel_base].reshape(count, cfg.lfr_dim)
        self._next_window = upto
        return (feats + self.means) * self.vars

    # -- public -----------------------------------------------------------
    def stage(self, samples: np.ndarray):
        """Phase 1 of a batched accept: absorb samples, return
        (waveform_buffer, n_complete_frames) for an external batched fbank
        call. Follow with commit(mel, is_final)."""
        samples = np.asarray(samples, dtype=np.float32)
        buf = np.concatenate([self._residual, samples])
        n = num_frames(len(buf), self.cfg)
        if n > 0:
            self._residual = buf[n * self.cfg.frame_shift:]
        else:
            self._residual = buf
        return buf, n

    def commit(self, mel: Optional[np.ndarray],
               is_final: bool = False) -> np.ndarray:
        """Phase 2: push mel rows (stage()'s frame count) and emit the
        complete LFR+CMVN windows."""
        if mel is not None and mel.shape[0] > 0:
            if self._mel is None or len(self._mel) == 0:
                self._mel = np.asarray(mel, np.float32)
            else:
                self._mel = np.concatenate([self._mel, mel])
            self._mel_total += mel.shape[0]
        return self._emit(is_final)

    def accept(self, samples: np.ndarray, is_final: bool = False
               ) -> np.ndarray:
        """Feed raw float32 samples; returns the newly complete LFR+CMVN
        rows [n, lfr_dim] (numpy)."""
        buf, n = self.stage(samples)
        mel = self._fbank_chunk(buf) if n > 0 else None
        return self.commit(mel, is_final)

    def _emit(self, is_final: bool) -> np.ndarray:
        cfg = self.cfg
        left = (cfg.lfr_m - 1) // 2
        if is_final:
            # offline window count: ceil(T / lfr_n), tail repeats last frame
            upto = -(-self._mel_total // cfg.lfr_n)
            out = self._emit_windows(upto)
            self.reset()
            return out
        # window i is complete when its last tap i*lfr_n + (lfr_m-1) - left
        # exists
        upto = (self._mel_total - 1 - (cfg.lfr_m - 1) + left) // cfg.lfr_n + 1
        out = self._emit_windows(max(upto, 0))
        # trim consumed mel frames (next window's earliest tap)
        keep_from = max(self._next_window * cfg.lfr_n - left, 0)
        if self._mel is not None and keep_from > self._mel_base:
            self._mel = self._mel[keep_from - self._mel_base:]
            self._mel_base = keep_from
        return out


def offline_window_samples(fcfg: FrontendConfig, lfr_bucket: int) -> int:
    """Samples one lfr_bucket window of the offline front-end consumes."""
    return (fcfg.frame_length
            + (lfr_bucket * fcfg.lfr_n - 1) * fcfg.frame_shift)


def _frontend_feats(ex, fcfg: FrontendConfig, b: int, lfr_bucket: int,
                    win, n_mel, means, vars_):
    """[b, need] int16 windows -> fbank -> LFR gather -> CMVN -> [b,
    lfr_bucket, lfr_dim]. Exact apply_lfr semantics: taps clamped per
    item to its n_mel valid mel rows (first-frame left pad, last-frame
    tail repeat); rows past an item's ceil(n/lfr_n) are repeats the model
    masks."""
    dev = win.device
    m, n = fcfg.lfr_m, fcfg.lfr_n
    mel_bucket = lfr_bucket * n
    left = (m - 1) // 2
    frame_idx = (torch.arange(mel_bucket, device=dev)[:, None]
                 * fcfg.frame_shift
                 + torch.arange(fcfg.frame_length, device=dev)[None, :])
    lfr_idx = (torch.arange(lfr_bucket, device=dev)[:, None] * n
               + torch.arange(m, device=dev)[None, :] - left)
    frames = win[:, frame_idx].float()
    mel = ex.frames_to_mel(
        (frames * (fcfg.scale_input / 32768.0)).reshape(b * mel_bucket, -1)
    ).reshape(b, mel_bucket, -1)
    top = (n_mel.long() - 1).clamp_min(0)
    idx = torch.minimum(lfr_idx.clamp_min(0)[None], top[:, None, None])
    feats = torch.take_along_dim(
        mel, idx.reshape(b, -1)[:, :, None], dim=1
    ).reshape(b, lfr_bucket, m * fcfg.n_mels)
    return (feats + means) * vars_


def offline_frontend_device(bufs, ns, lfr_bucket: int, cfg: FrontendConfig,
                            means=None, vars_=None, batch_b: int = None,
                            device="cuda"):
    """Front-end of one pass-2 chunk on the device: the segments' samples
    upload once as int16 (PCM-grid exact after quantize_pcm) and fbank,
    LFR and CMVN run there, giving the [B, lfr_bucket, lfr_dim] feats the
    model consumes. ns: mel frame counts per segment; rows past len(bufs)
    up to batch_b are zero padding."""
    dev = resolve_device(device)
    if batch_b is None:
        batch_b = len(bufs)
    need = offline_window_samples(cfg, lfr_bucket)
    waves = np.zeros((batch_b, need), np.int16)
    n_mel = np.zeros(batch_b, np.int64)
    for i, (buf, nf) in enumerate(zip(bufs, ns)):
        k = min(len(buf), need)
        waves[i, :k] = (quantize_pcm(np.asarray(buf[:k], np.float32))
                        * 32768.0).astype(np.int16)
        n_mel[i] = nf
    if means is None:
        means = np.zeros(cfg.lfr_dim, np.float32)
    if vars_ is None:
        vars_ = np.ones(cfg.lfr_dim, np.float32)
    return _frontend_feats(
        get_extractor(cfg), cfg, batch_b, lfr_bucket,
        torch.from_numpy(waves).to(dev), torch.from_numpy(n_mel).to(dev),
        torch.as_tensor(np.asarray(means, np.float32), device=dev),
        torch.as_tensor(np.asarray(vars_, np.float32), device=dev))


def ring_frontend_device(ring, slot_ids, abs_starts, ns, lfr_bucket: int,
                         cfg: FrontendConfig, means=None, vars_=None,
                         batch_b: int = None):
    """Device feats for segments that still live in the engine's per-slot
    int16 audio ring [C, R] (written once a tick by the fused VAD step):
    each segment's window is gathered there with modular indices, so the
    pass-2 lane uploads no audio, then the same _frontend_feats tail as
    offline_frontend_device runs. Rows past len(slot_ids) up to batch_b
    are padding (slot 0 from offset 0, n_mel 0). Returns None when the
    window does not fit the ring (the caller takes the upload path)."""
    dev = ring.device
    if batch_b is None:
        batch_b = len(slot_ids)
    r = ring.shape[1]
    need = offline_window_samples(cfg, lfr_bucket)
    if need > r:
        return None
    idx = np.zeros((3, batch_b), np.int64)
    for i, (sid, a, nf) in enumerate(zip(slot_ids, abs_starts, ns)):
        idx[:, i] = (sid, a % r, nf)
    sl, off, n_mel = to_device(dev, idx)
    cols = (off[:, None] + torch.arange(need, device=dev)[None, :]) % r
    win = ring[sl[:, None], cols]
    if means is None:
        means = np.zeros(cfg.lfr_dim, np.float32)
    if vars_ is None:
        vars_ = np.ones(cfg.lfr_dim, np.float32)
    return _frontend_feats(
        get_extractor(cfg), cfg, batch_b, lfr_bucket, win, n_mel,
        torch.as_tensor(np.asarray(means, np.float32), device=dev),
        torch.as_tensor(np.asarray(vars_, np.float32), device=dev))


def offline_frontend(samples, cfg: FrontendConfig, means=None, vars_=None,
                     device="cuda") -> np.ndarray:
    """One-shot front-end (fbank on `device`, then host LFR and CMVN), the
    offline reference path. Returns [T_lfr, lfr_dim] numpy."""
    dev = resolve_device(device)
    mel = get_extractor(cfg)(samples, device=dev).cpu().numpy()
    if mel.shape[0] == 0:
        return np.zeros((0, cfg.lfr_dim), np.float32)
    feats = apply_lfr(mel, cfg.lfr_m, cfg.lfr_n)
    if means is None:
        means = np.zeros(cfg.lfr_dim, np.float32)
    if vars_ is None:
        vars_ = np.ones(cfg.lfr_dim, np.float32)
    return np.asarray(apply_cmvn(feats, means, vars_), np.float32)
