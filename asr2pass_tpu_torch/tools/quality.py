#!/usr/bin/env python3
"""Audio quality filters: SNR estimation, clipping and DNSMOS scores
(utils/snr_filter.py / DNSMOS role).

Counterpart of the JAX package's tools/quality.py. The reference gates
training data on DNSMOS ONNX scores and an SNR filter (SURVEY.md §2.3
#40). The SNR/energy/clipping gates are self-contained numpy; DnsmosScorer
runs the published DNSMOS graphs (model_v8.onnx, sig_bak_ovr.onnx, from a
directory the user supplies) on tools/onnx_reader's executor, on the card
unless device="cpu".

CLI: python -m asr2pass_tpu_torch.tools.quality --scp wav.scp
        [--min-snr 15] [--max-clip 0.001] [--dnsmos-dir DIR
        [--min-mos 3.0]] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from asr2pass_tpu_torch.tools.transcribe import add_device_arg


def estimate_snr(wave: np.ndarray, fs: int = 16000,
                 frame_ms: int = 25, shift_ms: int = 10) -> float:
    """Energy-percentile SNR estimate in dB: speech energy (top decile
    frames) over noise floor (bottom decile)."""
    flen = fs * frame_ms // 1000
    shift = fs * shift_ms // 1000
    if len(wave) < flen:
        return 0.0
    n = 1 + (len(wave) - flen) // shift
    idx = np.arange(n)[:, None] * shift + np.arange(flen)[None, :]
    frames = wave[idx]
    energy = np.mean(frames ** 2, axis=1) + 1e-10
    lo = np.percentile(energy, 10)
    hi = np.percentile(energy, 90)
    return float(10 * np.log10(hi / lo))


def clipping_ratio(wave: np.ndarray, thresh: float = 0.999) -> float:
    if len(wave) == 0:
        return 1.0  # empty input: treat as unusable
    return float(np.mean(np.abs(wave) >= thresh))


def passes_quality(wave: np.ndarray, fs: int = 16000,
                   min_snr_db: float = 15.0,
                   max_clip: float = 0.001) -> bool:
    return (estimate_snr(wave, fs) >= min_snr_db
            and clipping_ratio(wave) <= max_clip)


# --------------------------------------------------------------------------
# DNSMOS (utils/dnsmos_local.py role): P.808 MOS + P.835 SIG/BAK/OVRL
# networks executed with torch via tools/onnx_reader (no onnxruntime).
# Model files are the published DNSMOS checkpoints (model_v8.onnx,
# sig_bak_ovr.onnx) from a user-supplied directory.
# --------------------------------------------------------------------------

_DNS_FS = 16000
_DNS_INPUT_S = 9.01


def _slaney_mel_fb(n_mels: int, n_fft: int, fs: int) -> np.ndarray:
    """librosa.filters.mel equivalent (htk=False, norm='slaney')."""
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3.0)
        log_region = f >= 1000.0
        mel = np.where(log_region,
                       15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = m * (200.0 / 3.0)
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                                 * (m - 15.0)), f)
        return f

    fft_freqs = np.linspace(0, fs / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fs / 2),
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def _melspec_db(audio: np.ndarray, n_mels=120, frame_size=320,
                hop=160, fs=_DNS_FS) -> np.ndarray:
    """librosa.feature.melspectrogram(n_fft=frame_size+1) + power_to_db
    (ref=max, +40)/40, transposed to [T, n_mels] — the P.808 front end."""
    n_fft = frame_size + 1
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float64), pad, mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)  # periodic hann
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * win
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # [T, F]
    mel = spec @ _slaney_mel_fb(n_mels, n_fft, fs).T             # [T, M]
    amin, top_db = 1e-10, 80.0
    db = 10.0 * np.log10(np.maximum(mel, amin))
    db -= 10.0 * np.log10(max(amin, mel.max()))
    db = np.maximum(db, db.max() - top_db)
    return ((db + 40.0) / 40.0).astype(np.float32)


class DnsmosScorer:
    """MOS prediction over 1 s hops of 9.01 s windows, averaged
    (dnsmos_local.py ComputeScore semantics). The graphs' input shapes
    are fixed, so each runs through one OnnxExecutor built here, with its
    weights moved to `device` once."""

    def __init__(self, model_dir: str, personalized: bool = False,
                 device="cuda"):
        import os

        from asr2pass_tpu_torch.tools.onnx_reader import (OnnxExecutor,
                                                          read_onnx)

        def compiled(path):
            ex = OnnxExecutor(read_onnx(path), device)
            return lambda x: ex(x).cpu().numpy()

        self.p808 = compiled(os.path.join(model_dir, "model_v8.onnx"))
        self.primary = None
        sbo = os.path.join(model_dir, "sig_bak_ovr.onnx")
        if os.path.exists(sbo):
            self.primary = compiled(sbo)
        self.personalized = personalized

    @staticmethod
    def _poly(coeffs, x):
        return float(np.polyval(coeffs, x))

    def score(self, audio: np.ndarray, fs: int = _DNS_FS) -> dict:
        if fs != _DNS_FS:
            from asr2pass_tpu_torch.frontend.audio import linear_resample

            audio = linear_resample(audio, fs, _DNS_FS)
        need = int(_DNS_INPUT_S * _DNS_FS)
        if len(audio) == 0:
            # empty/corrupt input: score as unusable rather than looping
            out = {"p808_mos": 0.0}
            if self.primary is not None:
                out.update(sig=0.0, bak=0.0, ovrl=0.0)
            return out
        while len(audio) < need:
            audio = np.concatenate([audio, audio])
        num_hops = int(np.floor(len(audio) / _DNS_FS) - _DNS_INPUT_S) + 1
        p808_scores, sig, bak, ovr = [], [], [], []
        for k in range(num_hops):
            seg = audio[k * _DNS_FS: k * _DNS_FS + need]
            if len(seg) < need:
                continue
            feats = _melspec_db(seg[:-160])[None]
            p808_scores.append(float(np.asarray(self.p808(feats))[0][0]))
            if self.primary is not None:
                raw = np.asarray(self.primary(
                    seg[None].astype(np.float32)))[0]
                if self.personalized:
                    ps = [-0.01019296, 0.02751166, 1.19576786, -0.24348726]
                    pb = [-0.04976499, 0.44276479, -0.1644611, 0.96883132]
                    po = [-0.00533021, 0.005101, 1.18058466, -0.11236046]
                else:
                    ps = [-0.08397278, 1.22083953, 0.0052439]
                    pb = [-0.13166888, 1.60915514, -0.39604546]
                    po = [-0.06766283, 1.11546468, 0.04602535]
                sig.append(self._poly(ps, raw[0]))
                bak.append(self._poly(pb, raw[1]))
                ovr.append(self._poly(po, raw[2]))
        out = {"p808_mos": float(np.mean(p808_scores))}
        if sig:
            out.update(sig=float(np.mean(sig)), bak=float(np.mean(bak)),
                       ovrl=float(np.mean(ovr)))
        return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scp", required=True)
    p.add_argument("--min-snr", type=float, default=15.0)
    p.add_argument("--max-clip", type=float, default=0.001)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--dnsmos-dir", default=None,
                   help="dir with DNSMOS model_v8.onnx (+sig_bak_ovr.onnx) "
                        "to add MOS columns")
    p.add_argument("--min-mos", type=float, default=0.0,
                   help="drop utterances below this P.808 MOS")
    add_device_arg(p)
    args = p.parse_args(argv)

    from asr2pass_tpu_torch.frontend.audio import load_audio_file

    scorer = (DnsmosScorer(args.dnsmos_dir, device=args.device)
              if args.dnsmos_dir else None)
    with open(args.scp, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            name, path = (parts[0], parts[1]) if len(parts) > 1 \
                else (parts[0], parts[0])
            wave = load_audio_file(path, args.fs)
            snr = estimate_snr(wave, args.fs)
            clip = clipping_ratio(wave)
            ok = snr >= args.min_snr and clip <= args.max_clip
            mos_col = ""
            if scorer is not None:
                mos = scorer.score(wave, args.fs)
                ok = ok and mos["p808_mos"] >= args.min_mos
                mos_col = "\t" + "\t".join(
                    f"{k}={v:.2f}" for k, v in mos.items())
            print(f"{name}\tsnr={snr:.1f}dB\tclip={clip:.4f}{mos_col}\t"
                  f"{'KEEP' if ok else 'DROP'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
