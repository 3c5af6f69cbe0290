"""Plain front-end: kaldi log-mel fbank (snip_edges, DC removal,
pre-emphasis 0.97, window, |rfft|^2 over 512 points, mel triangles,
natural log floored at float32 eps), LFR stacking and CMVN, in float32.

`offline_feats` is what one offline segment's recognizer sees. The
`StreamingFrontend` class is a frozen copy of the port's chunk-by-chunk
front-end (runtime/streaming_frontend.py), which the VAD is fed through:
it decides how many feature rows each 1 s window of the offline VAD
hands the decision automaton. Nothing here imports the program.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def num_frames(num_samples: int, fcfg) -> int:
    if num_samples < fcfg.frame_length:
        return 0
    return 1 + (num_samples - fcfg.frame_length) // fcfg.frame_shift


def _window(fcfg) -> np.ndarray:
    n = fcfg.frame_length
    i = np.arange(n, dtype=np.float64)
    a = 2.0 * math.pi / (n - 1)
    kind = fcfg.window.lower()
    if kind in ("hanning", "hann"):
        return 0.5 - 0.5 * np.cos(a * i)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if kind == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    raise ValueError(f"no window {fcfg.window}")


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=4)
def _mel_bank(fcfg) -> np.ndarray:
    """Kaldi MelBanks over the first n_fft/2 bins: [n_fft/2, n_mels]."""
    n_fft = fcfg.n_fft
    high = fcfg.high_freq if fcfg.high_freq > 0 else (0.5 * fcfg.fs
                                                      + fcfg.high_freq)
    lo = _mel(fcfg.low_freq)
    delta = (_mel(high) - lo) / (fcfg.n_mels + 1)
    freqs = _mel(np.arange(n_fft // 2) * (fcfg.fs / n_fft))
    bank = np.zeros((n_fft // 2, fcfg.n_mels))
    for m in range(fcfg.n_mels):
        left = lo + m * delta
        centre, right = lo + (m + 1) * delta, lo + (m + 2) * delta
        up = (freqs - left) / (centre - left)
        down = (right - freqs) / (right - centre)
        bank[:, m] = np.maximum(0.0, np.minimum(up, down))
    return bank


def fbank(wave: np.ndarray, fcfg, device) -> torch.Tensor:
    """[N] float waveform in [-1, 1] -> [frames, n_mels] log-mel."""
    n = num_frames(len(wave), fcfg)
    if n == 0:
        return torch.zeros(0, fcfg.n_mels, device=device)
    x = torch.as_tensor(np.asarray(wave, np.float32), device=device)
    idx = (torch.arange(n, device=device)[:, None] * fcfg.frame_shift
           + torch.arange(fcfg.frame_length, device=device)[None, :])
    frames = x[idx] * fcfg.scale_input
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - fcfg.preemphasis * torch.cat(
        [frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames * torch.as_tensor(_window(fcfg), dtype=torch.float32,
                                      device=device)
    spec = torch.fft.rfft(frames, n=fcfg.n_fft)[:, : fcfg.n_fft // 2]
    power = spec.real.square() + spec.imag.square()
    bank = torch.as_tensor(_mel_bank(fcfg), dtype=torch.float32,
                           device=device)
    return torch.log((power @ bank).clamp_min(_EPS))


def lfr(mel: np.ndarray, m: int, n: int) -> np.ndarray:
    """Stack m frames every n, the first repeated (m-1)//2 times on the
    left, the last repeated past the end: [ceil(T/n), D*m]."""
    t, d = mel.shape
    t_lfr = -(-t // n)
    idx = (np.arange(t_lfr)[:, None] * n + np.arange(m)[None, :]
           - (m - 1) // 2)
    return mel[np.clip(idx, 0, t - 1)].reshape(t_lfr, d * m)


def offline_feats(wave: np.ndarray, fcfg, means, vars_, device
                  ) -> torch.Tensor:
    """One segment's LFR+CMVN features [T, 560] on `device`."""
    mel = fbank(wave, fcfg, device).cpu().numpy()
    feats = (lfr(mel, fcfg.lfr_m, fcfg.lfr_n) + means) * vars_
    return torch.as_tensor(np.asarray(feats, np.float32), device=device)


class StreamingFrontend:
    """Chunk-by-chunk front-end (a frozen copy of the port's): absorbs
    samples, emits the LFR+CMVN rows that are complete, and on the final
    chunk the offline tail."""

    def __init__(self, fcfg, means=None, vars_=None, device="cpu"):
        self.cfg = fcfg
        self.device = device
        d = fcfg.lfr_dim
        self.means = (np.zeros(d, np.float32) if means is None
                      else np.asarray(means, np.float32))
        self.vars = (np.ones(d, np.float32) if vars_ is None
                     else np.asarray(vars_, np.float32))
        self.reset()

    def reset(self):
        self._residual = np.zeros(0, np.float32)
        self._mel: Optional[np.ndarray] = None
        self._mel_base = 0
        self._mel_total = 0
        self._next_window = 0

    def _emit_windows(self, upto: int) -> np.ndarray:
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

    def accept(self, samples: np.ndarray, is_final: bool = False
               ) -> np.ndarray:
        cfg = self.cfg
        buf = np.concatenate([self._residual,
                              np.asarray(samples, np.float32)])
        n = num_frames(len(buf), cfg)
        self._residual = buf[n * cfg.frame_shift:] if n > 0 else buf
        if n > 0:
            mel = fbank(buf[: cfg.frame_length + (n - 1) * cfg.frame_shift],
                        cfg, self.device).cpu().numpy()
            self._mel = (mel if self._mel is None or len(self._mel) == 0
                         else np.concatenate([self._mel, mel]))
            self._mel_total += n
        left = (cfg.lfr_m - 1) // 2
        if is_final:
            out = self._emit_windows(-(-self._mel_total // cfg.lfr_n))
            self.reset()
            return out
        upto = (self._mel_total - 1 - (cfg.lfr_m - 1) + left) // cfg.lfr_n + 1
        out = self._emit_windows(max(upto, 0))
        keep_from = max(self._next_window * cfg.lfr_n - left, 0)
        if self._mel is not None and keep_from > self._mel_base:
            self._mel = self._mel[keep_from - self._mel_base:]
            self._mel_base = keep_from
        return out
