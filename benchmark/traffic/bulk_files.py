"""Bulk transcription: one client sends whole files, each after the last
has come back (a closed loop, as tools/transcribe.py runs a wav.scp).

A file is speech-like bursts between pauses of digital silence, 16 kHz,
on the 16-bit PCM grid, as a decoded WAV file is. The cell's parameters:
- file_seconds: the lengths of the files of the pool;
- burst_s, pause_s: the ranges bursts and pauses are drawn from;
- layout_seed: draws each file's bursts and pauses, so every run seed
  serves the same set of segment lengths;
- sample_files: how many served files the check compares.
The run's seed draws the order the pool is served in (a new permutation
every pass) and the sound inside each burst. The window serves whole
passes over the pool: it closes when the pass in progress at `seconds`
ends, so every run and every seed does the same work, in another order.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List

import numpy as np

FS = 16000


def synth(seconds: float, g, device):
    """A gliding harmonic tone under a 3-5 Hz syllable envelope, plus
    noise, in [-1, 1]: float64 on `device`, drawn from generator g."""
    import torch

    n = int(seconds * FS)
    r = torch.rand(4, generator=g, device=device, dtype=torch.float64)
    t = torch.arange(n, device=device, dtype=torch.float64) / FS
    env = 0.5 * (1 + torch.sin(2 * math.pi * (3 + 2 * r[0]) * t
                               + 2 * math.pi * r[1]))
    f0 = (100 + 150 * r[2]) * (1 + 0.2 * torch.sin(2 * math.pi * 0.3 * t))
    phase = 2 * math.pi * torch.cumsum(f0, 0) / FS
    x = sum(torch.sin(k * phase) / k for k in range(1, 6))
    noise = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    return (0.15 * env * x + 0.01 * noise).clamp(-1, 1)


def layout(seconds: float, burst_s, pause_s, rng) -> List[tuple]:
    """[(start_s, length_s)] of the bursts of one file: a pause, a burst,
    and so on, ending with at least the longest pause of silence."""
    out, at = [], 0.0
    while True:
        at += rng.uniform(*pause_s)
        length = rng.uniform(*burst_s)
        if at + length + pause_s[1] > seconds:
            return out
        out.append((at, length))
        at += length


def pool(params: dict, seed: int, device="cpu") -> List[np.ndarray]:
    """The files, float32 on the PCM grid (the sound made on `device`)."""
    import torch

    lay = np.random.default_rng(params["layout_seed"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    files = []
    for seconds in params["file_seconds"]:
        wave = torch.zeros(int(seconds * FS), dtype=torch.float64,
                           device=device)
        for start, length in layout(seconds, params["burst_s"],
                                    params["pause_s"], lay):
            a = int(start * FS)
            burst = synth(length, g, device)
            wave[a: a + len(burst)] = burst
        pcm = torch.round(wave * 32768.0).clamp(-32768, 32767) / 32768.0
        files.append(pcm.float().cpu().numpy())
    return files


def passes(n: int, seed: int):
    """File indices of each pass: a new permutation of the pool."""
    rng = np.random.default_rng(seed + 1)
    while True:
        yield rng.permutation(n).tolist()


class Window:
    """What the window served."""

    def __init__(self):
        self.done = []          # common.Served records, completed
        self.errors = []        # what each failed request said
        self.attempted = 0
        self.failed = 0
        self.window_s = 0.0
        self.audio_s = 0.0
        self.pass_s: List[float] = []   # each whole pass's host seconds

    @property
    def completed(self) -> int:
        return len(self.done)


class Load:
    """The cell's traffic bound to the program's entry: the files made
    from the seed, the warm-up, the window, and what the harness reads of
    it. The harness knows nothing else of the traffic kind."""

    def __init__(self, family, entry: Callable, params: dict, seed: int,
                 device):
        self.family = family
        self.entry = entry
        self.params = params
        self.seed = seed
        self.files = pool(params, seed, device)

    def warm(self) -> None:
        """Every file once: the shapes the window will use, built and
        cached."""
        for samples in self.files:
            self.entry(samples)

    def drive(self, seconds: float, traced=None) -> Window:
        """Serve whole passes over the files, each in the seed's order,
        until `seconds` have passed since the first started. traced: a
        trace.Window around the whole window."""
        from benchmark.families import common

        out = Window()
        recorder = self.family.recorder
        order = passes(len(self.files), self.seed)
        if traced is not None:
            traced.start()
        t0 = time.perf_counter()
        t_pass = t0
        todo: List[int] = []
        while todo or time.perf_counter() - t0 < seconds:
            if not todo:
                todo = next(order)
            samples = self.files[todo.pop(0)]
            rec = common.Served(samples)
            recorder.current = rec
            out.attempted += 1
            try:
                rec.result = self.entry(samples)
            except Exception as exc:   # a failed request: counted, then on
                out.errors.append(f"{type(exc).__name__}: {exc}")
                out.failed += 1
                continue
            finally:
                recorder.current = None
                if not todo:
                    now = time.perf_counter()
                    out.pass_s.append(now - t_pass)
                    t_pass = now
            if not rec.result.segments:
                out.errors.append("a file came back with no segment")
                out.failed += 1
                continue
            out.done.append(rec)
            out.audio_s += rec.seconds
        out.window_s = time.perf_counter() - t0
        if traced is not None:
            traced.stop()
        return out

    def summary(self, window: Window) -> str:
        tokens = sum(len(seg["ids"]) for r in window.done
                     for seg in r.segments.values())
        return (f"{len(window.done)} files, {window.audio_s:.1f} audio s, "
                f"{tokens / max(window.audio_s, 1e-9):.2f} tokens an audio "
                f"s, passes of {len(self.files)} files "
                + " ".join(f"{s:.3f}" for s in window.pass_s) + " s")

    def sample(self, window: Window, seed: int) -> list:
        """What the check compares: served files drawn from the seed, the
        longest among them."""
        done = window.done
        if not done:
            return []
        k = self.params["sample_files"]
        longest = max(range(len(done)), key=lambda i: done[i].seconds)
        rng = np.random.default_rng(seed + 7)
        rest = [i for i in range(len(done)) if i != longest]
        pick = [longest] + list(rng.choice(
            rest, size=min(k - 1, len(rest)), replace=False))
        return [done[i] for i in sorted(pick)]

    def flops(self, window: Window) -> float:
        """The model FLOPs of the files the window completed."""
        return sum(self.family.flops(r) for r in window.done)
