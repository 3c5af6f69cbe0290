"""Kaldi-compatible log-mel fbank as matrix products.

Counterpart of the JAX package's frontend/fbank.py (FbankExtractor.
frames_to_mel): per frame remove the DC offset, preemphasis 0.97, window,
power spectrum, mel-triangular bins, natural log with the float32-eps
floor. The power spectrum is two products with DFT cos/sin matrices that
have the window folded in: frames [N, 400] @ C [400, 256] -> re, @ S ->
im; power = re^2 + im^2; logmel = log(power @ M [256, 80]).

These products must stay true fp32: the log turns reduced-precision
mantissa error into audible CER loss. On the card that needs TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False), which every entry
point that builds a model sets (utils.fp32_products).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from asr2pass_tpu_torch.config import FrontendConfig

_EPS = float(np.finfo(np.float32).eps)


def num_frames(num_samples: int, cfg: FrontendConfig) -> int:
    """Frame count with snip_edges=true (kaldi feature-window semantics)."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def _feature_window(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    w = cfg.window.lower()
    if w in ("hanning", "hann"):
        return 0.5 - 0.5 * np.cos(a * i)
    if w == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if w == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if w == "rectangular":
        return np.ones(n)
    if w == "blackman":
        return 0.42 - 0.5 * np.cos(a * i) + 0.08 * np.cos(2 * a * i)
    raise ValueError(f"unknown window type {cfg.window}")


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi MelBanks triangular weights over FFT bins [n_fft//2, n_mels]."""
    n_fft = cfg.n_fft
    nyquist = 0.5 * cfg.fs
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low = _mel_scale(cfg.low_freq)
    delta = (_mel_scale(high) - mel_low) / (cfg.n_mels + 1)
    mel_freqs = _mel_scale(np.arange(n_fft // 2) * (cfg.fs / n_fft))
    bank = np.zeros((n_fft // 2, cfg.n_mels), dtype=np.float64)
    for m in range(cfg.n_mels):
        left = mel_low + m * delta
        center = mel_low + (m + 1) * delta
        right = mel_low + (m + 2) * delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bank[:, m] = np.maximum(0.0, np.minimum(up, down))
    return bank


class FbankExtractor:
    """Log-mel fbank over frames already scaled to the int16 range; the
    matrices are kept per device."""

    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg
        win = _feature_window(cfg)
        k = np.arange(cfg.n_fft // 2)
        n = np.arange(cfg.frame_length)
        ang = 2.0 * math.pi * np.outer(n, k) / cfg.n_fft
        # fold the window into the DFT matrices: (x*win) @ C == x @ (win*C)
        self._host = {
            "cos": (win[:, None] * np.cos(ang)).astype(np.float32),
            "sin": (win[:, None] * -np.sin(ang)).astype(np.float32),
            "mel": mel_filterbank(cfg).astype(np.float32),
        }
        self._dev = {}

    def _mats(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {k: torch.from_numpy(v).to(device)
                              for k, v in self._host.items()}
        return self._dev[key]

    def frames_to_mel(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, frame_length] raw (already x32768) frames -> [N, n_mels]."""
        cfg = self.cfg
        mats = self._mats(frames.device)
        x = frames.float()
        if cfg.remove_dc_offset:
            x = x - x.mean(dim=-1, keepdim=True)
        if cfg.preemphasis != 0.0:
            prev = torch.cat([x[:, :1], x[:, :-1]], dim=-1)
            x = x - cfg.preemphasis * prev
        re = x @ mats["cos"]
        im = x @ mats["sin"]
        power = re * re + im * im
        mel = power @ mats["mel"]
        return torch.log(mel.clamp_min(_EPS))

    def __call__(self, wave, device) -> torch.Tensor:
        """[T] float32 waveform in [-1, 1] -> [num_frames, n_mels] on
        `device`."""
        cfg = self.cfg
        wave = torch.as_tensor(np.asarray(wave, np.float32), device=device)
        n = num_frames(int(wave.shape[0]), cfg)
        if n == 0:
            return torch.zeros((0, cfg.n_mels), dtype=torch.float32,
                               device=device)
        idx = (torch.arange(n, device=device)[:, None] * cfg.frame_shift
               + torch.arange(cfg.frame_length, device=device)[None, :])
        return self.frames_to_mel((wave * cfg.scale_input)[idx])


@functools.lru_cache(maxsize=8)
def get_extractor(cfg: FrontendConfig) -> FbankExtractor:
    return FbankExtractor(cfg)
