"""ctypes bindings of the port's native host library (native/src/*.cc).

Counterpart of the JAX package's native/bindings.py, for the three parts
on the serving path: the windowed-sinc resampler (`resample`), the E2E
VAD decision automaton (`NativeVad`) and the pruned CTC prefix beam with
its hotword trie (`serialize_context_trie`, `ctc_beam_decode`). The
sources are this package's own copies (src/); native.cc also holds the
Aho-Corasick bias automaton and the edit alignment, compiled here but not
bound yet.

The library is compiled at first use by `g++ -O3 -fPIC -std=c++17
-shared` into BUILD_DIR (git-ignored), one file per content of the
sources, and loaded with ctypes.CDLL, so every call releases the
interpreter lock. Nothing falls back: a failed build raises with the
compiler's log, and a call that the library refuses raises. The Python
versions of these functions (frontend/audio.py, vad/e2e_vad.py,
decode/ctc.py) run only when a caller asks for them by argument.

Each wrapper counts its calls into the library (`call_counts`), so a run
can show that its path went through the native code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_CALLS = {}

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def sources(src_dir: Path = SRC) -> list:
    """The library's sources: every .cc and the header they share."""
    return sorted([*src_dir.glob("*.cc"), *src_dir.glob("*.h")])


def build(src_dir: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile src_dir's .cc files into one shared library in build_dir,
    once per content of the sources, and return its path. The library is
    written under a temporary name and moved into place, so a process
    that builds at the same time never loads a half-written file. Raises
    RuntimeError with the compiler's output if the build fails."""
    srcs = sources(Path(src_dir))
    if not any(s.suffix == ".cc" for s in srcs):
        raise RuntimeError(f"no native sources in {src_dir}")
    digest = hashlib.sha1()
    for src in srcs:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    build_dir = Path(build_dir)
    lib = build_dir / f"libasr2native_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is compiled "
                           f"from {src_dir} at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f".{lib.stem}.{os.getpid()}.{threading.get_ident()}.so"
    res = subprocess.run(
        [cxx, *CXXFLAGS, "-o", str(tmp),
         *(str(s) for s in srcs if s.suffix == ".cc")],
        capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) on {src_dir}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _declare(lib) -> None:
    c_int, c_i32, c_dbl = ctypes.c_int, ctypes.c_int32, ctypes.c_double
    lib.a2p_resample.restype = ctypes.c_int64
    lib.a2p_resample.argtypes = [_f32p, ctypes.c_int64, c_int, c_int, c_int,
                                 _f32p]
    lib.a2p_vad_new.restype = ctypes.c_void_p
    lib.a2p_vad_new.argtypes = [
        c_int, c_int, c_int, c_int, c_int, c_int, c_dbl, c_int, c_int, c_int,
        c_int, c_dbl, c_int, c_dbl, c_dbl, c_int]
    lib.a2p_vad_free.restype = None
    lib.a2p_vad_free.argtypes = [ctypes.c_void_p]
    lib.a2p_vad_reset.restype = None
    lib.a2p_vad_reset.argtypes = [ctypes.c_void_p]
    lib.a2p_vad_overrides.restype = None
    lib.a2p_vad_overrides.argtypes = [ctypes.c_void_p, c_int, c_int, c_dbl]
    lib.a2p_vad_chunk.restype = None
    lib.a2p_vad_chunk.argtypes = [ctypes.c_void_p, _f32p, _f64p, c_i32,
                                  c_i32]
    lib.a2p_vad_seg_count.restype = c_i32
    lib.a2p_vad_seg_count.argtypes = [ctypes.c_void_p]
    lib.a2p_vad_seg.restype = None
    lib.a2p_vad_seg.argtypes = [ctypes.c_void_p, c_i32, _i32p]
    lib.a2p_ctcbeam_decode.restype = c_i32
    lib.a2p_ctcbeam_decode.argtypes = [
        _i32p, _f32p, c_i32, c_i32, c_i32, c_i32, c_i32, _i32p, _i32p,
        _f32p, _u8p, _i32p, _i32p, _i32p, _f32p, c_i32]


def library():
    """The loaded library, built first if need be."""
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(SRC, BUILD_DIR)))
            _declare(lib)
            _lib = lib
    return _lib


def _count(name: str) -> None:
    with _count_lock:
        _CALLS[name] = _CALLS.get(name, 0) + 1


def call_counts() -> dict:
    """Calls into the library since the last reset, by function:
    `resample`, `vad_chunk` (one a chunk of one stream) and
    `ctc_beam_decode` (one a segment)."""
    with _count_lock:
        return {k: _CALLS.get(k, 0)
                for k in ("resample", "vad_chunk", "ctc_beam_decode")}


def reset_call_counts() -> None:
    with _count_lock:
        _CALLS.clear()


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


# ---------------------------------------------------------------------------
# the resampler
# ---------------------------------------------------------------------------

def resample(x: np.ndarray, fs_in: int, fs_out: int,
             num_zeros: int = 6) -> np.ndarray:
    """a2p_resample: x at fs_in -> float32 at fs_out (Kaldi
    LinearResample semantics; frontend/audio.linear_resample's native
    branch)."""
    if fs_in <= 0 or fs_out <= 0 or num_zeros <= 0:
        raise ValueError(f"resample: rates {fs_in}, {fs_out} and "
                         f"num_zeros {num_zeros} must be positive")
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"resample takes a 1-D waveform, got {x.shape}")
    out = np.empty(int(np.ceil(len(x) * fs_out / fs_in)) + 16, np.float32)
    lib = library()
    _count("resample")
    n = lib.a2p_resample(_ptr(x, _f32p), len(x), int(fs_in), int(fs_out),
                         int(num_zeros), _ptr(out, _f32p))
    if not 0 <= n <= len(out):
        raise RuntimeError(f"a2p_resample returned {n} samples for a "
                           f"buffer of {len(out)}")
    return out[:n]


# ---------------------------------------------------------------------------
# the E2E VAD automaton
# ---------------------------------------------------------------------------

class NativeVad:
    """E2E VAD decision automaton's per-frame loop (e2e_vad.cc), one
    instance per stream; vad/e2e_vad.E2EVadStateMachine keeps decibel
    extraction and the online segment emission in Python.

    The handle is freed by close() (or when the object is collected).
    A lock makes close() safe against a call from another thread: a call
    after close() raises instead of touching freed memory."""

    def __init__(self, opts):
        self._lib = library()
        self._lock = threading.Lock()
        self._handle = self._lib.a2p_vad_new(
            int(opts.detect_mode), int(opts.max_end_silence_time),
            int(opts.max_start_silence_time), int(opts.window_size_ms),
            int(opts.sil_to_speech_time_thres),
            int(opts.speech_to_sil_time_thres),
            float(opts.speech_2_noise_ratio), int(opts.do_extend),
            int(opts.lookback_time_start_point),
            int(opts.lookahead_time_end_point),
            int(opts.max_single_segment_time), float(opts.snr_thres),
            int(opts.noise_frame_num_used_for_snr),
            float(opts.decibel_thres), float(opts.speech_noise_thres),
            int(opts.frame_in_ms))
        if not self._handle:
            raise RuntimeError("a2p_vad_new failed")
        self._seg_buf = np.empty(4, np.int32)

    def _live(self):
        if self._handle is None:
            raise RuntimeError("the VAD automaton was closed")
        return self._handle

    def reset(self):
        with self._lock:
            self._lib.a2p_vad_reset(self._live())

    def overrides(self, max_end_sil=None, max_single_seg=None,
                  speech_noise_thres=None):
        """Per-call options; None keeps the current value."""
        with self._lock:
            self._lib.a2p_vad_overrides(
                self._live(),
                -1 if max_end_sil is None else int(max_end_sil),
                -1 if max_single_seg is None else int(max_single_seg),
                float("nan") if speech_noise_thres is None
                else float(speech_noise_thres))

    def chunk(self, sil_prob: np.ndarray, decibel: np.ndarray,
              is_final: bool):
        """One chunk's frames: summed silence posterior and decibel, one
        each a frame."""
        sp = np.ascontiguousarray(sil_prob, np.float32)
        dec = np.ascontiguousarray(decibel, np.float64)
        if sp.ndim != 1 or dec.shape != sp.shape:
            raise ValueError(f"vad chunk: sil_prob {sp.shape} and decibel "
                             f"{dec.shape} must be one value a frame")
        with self._lock:
            handle = self._live()
            _count("vad_chunk")
            self._lib.a2p_vad_chunk(handle, _ptr(sp, _f32p),
                                    _ptr(dec, _f64p), len(sp),
                                    1 if is_final else 0)

    def seg_count(self) -> int:
        with self._lock:
            return int(self._lib.a2p_vad_seg_count(self._live()))

    def seg(self, i: int):
        """(start_ms, end_ms, contain_start, contain_end)"""
        with self._lock:
            handle = self._live()
            n = int(self._lib.a2p_vad_seg_count(handle))
            if not 0 <= i < n:
                raise IndexError(f"segment {i} of {n}")
            self._lib.a2p_vad_seg(handle, int(i),
                                  _ptr(self._seg_buf, _i32p))
            b = self._seg_buf
            return int(b[0]), int(b[1]), bool(b[2]), bool(b[3])

    def close(self):
        """Free the handle; later calls raise. Idempotent."""
        lock = getattr(self, "_lock", None)
        if lock is None:        # __init__ did not get that far
            return
        with lock:
            if getattr(self, "_handle", None):
                self._lib.a2p_vad_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# the pruned CTC prefix beam
# ---------------------------------------------------------------------------

def serialize_context_trie(context, token2id):
    """ContextGraph -> flat (parent, unit, score, is_end) arrays (root =
    row 0) for the native CTC beam. Edges whose token string is not a
    vocab token get unit=-1: candidate ids are >= 0 so they can never
    match — exactly the Python beam's reachability (it compares
    id_to_token(tok) against the edge token) — while the node STRUCTURE
    (has-children, totals) stays identical for the retract semantics."""
    parents = [0]
    units = [0]
    scores = [0.0]
    ends = [0]

    def walk(node, idx):
        for tok, child in node.children.items():
            cidx = len(parents)
            parents.append(idx)
            units.append(int(token2id.get(tok, -1)))
            scores.append(float(child.score))
            ends.append(int(child.is_end))
            walk(child, cidx)

    walk(context.root, 0)
    return (np.asarray(parents, np.int32), np.asarray(units, np.int32),
            np.asarray(scores, np.float32), np.asarray(ends, np.uint8))


def ctc_beam_decode(cand_ids: np.ndarray, cand_logp: np.ndarray,
                    length: int, beam: int = 10, blank_id: int = 0,
                    trie=None):
    """Native prefix beam over [T, K] pruned candidates; returns the
    n-best [(ids, score, times)] list with the semantics of
    decode/ctc._prefix_beam_over_frames. `trie` is
    serialize_context_trie's arrays or None. Raises on shapes the
    library does not take and when it refuses the input."""
    cand = np.ascontiguousarray(cand_ids[:length], np.int32)
    lp = np.ascontiguousarray(cand_logp[:length], np.float32)
    if cand.ndim != 2 or cand.shape != lp.shape:
        raise ValueError(f"ctc beam: candidate ids {cand.shape} and "
                         f"log-probs {lp.shape} must both be [T, K]")
    if beam < 1:
        raise ValueError(f"ctc beam: beam {beam} < 1")
    t, k = cand.shape
    max_len = max(t, 1)
    out_ids = np.zeros((beam, max_len), np.int32)
    out_times = np.zeros((beam, max_len), np.int32)
    out_lens = np.zeros(beam, np.int32)
    out_scores = np.zeros(beam, np.float32)
    if trie is not None:
        parents, units, scores, ends = (
            np.ascontiguousarray(a, dt) for a, dt in zip(
                trie, (np.int32, np.int32, np.float32, np.uint8)))
        if not len(parents) == len(units) == len(scores) == len(ends):
            raise ValueError("ctc beam: the trie's arrays differ in length")
        n_nodes = len(parents)
        pa, un = _ptr(parents, _i32p), _ptr(units, _i32p)
        sc, en = _ptr(scores, _f32p), _ptr(ends, _u8p)
    else:
        n_nodes = 0
        pa = un = ctypes.cast(None, _i32p)
        sc = ctypes.cast(None, _f32p)
        en = ctypes.cast(None, _u8p)
    lib = library()
    _count("ctc_beam_decode")
    n = lib.a2p_ctcbeam_decode(
        _ptr(cand, _i32p), _ptr(lp, _f32p), t, k, int(beam), int(blank_id),
        n_nodes, pa, un, sc, en, _ptr(out_ids, _i32p),
        _ptr(out_times, _i32p), _ptr(out_lens, _i32p),
        _ptr(out_scores, _f32p), max_len)
    if n < 0:
        raise RuntimeError(f"a2p_ctcbeam_decode refused its input ({n}): "
                           f"T={t}, K={k}, beam={beam}, {n_nodes} trie "
                           "nodes")
    out = []
    for i in range(n):
        ln = int(out_lens[i])
        ids = [int(x) for x in out_ids[i, :ln]]
        times = [int(x) for x in out_times[i, :ln] if x >= 0]
        out.append((ids, float(out_scores[i]), times))
    return out
