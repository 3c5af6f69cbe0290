"""ctypes bindings of the port's native host library (native/src/*.cc).

Counterpart of the JAX package's native/bindings.py: the windowed-sinc
resampler (`resample`), the E2E VAD decision automaton (`NativeVad`), the
pruned CTC prefix beam with its hotword trie (`serialize_context_trie`,
`ctc_beam_decode`), the Aho-Corasick bias automaton (`NativeAcBias`), the
lexicon-trie x n-gram LM beam (`NativeLmDecoder`), the OpenFST reader with
its linear-input shortest path (`NativeFst`) and the TLG token passer
(`NativeTlgFstDecoder`), and the Levenshtein alignment of the CER tools
(`edit_align`). The sources are this package's own copies (src/).

The library is compiled at first use by `g++ -O3 -fPIC -std=c++17
-shared` into BUILD_DIR (git-ignored), one file per content of the
sources, under a lock file there so that one process compiles while the
others wait, and loaded with ctypes.CDLL, so every call releases the
interpreter lock. Nothing falls back: a failed build raises with the
compiler's log, and a call that the library refuses raises. The Python
versions of these functions (frontend/audio.py, vad/e2e_vad.py,
decode/ctc.py, decode/lm_decoder.py) run only when a caller asks for them
by argument; tools/compute_wer.align_plain is the alignment's, for the
tests.

Every handle is freed by close() (or when its object is collected) and
holds a lock, so a call after close() raises instead of touching freed
memory. A handle that others point into (a graph, a bias automaton)
refuses close() while a decoder uses it. Each wrapper counts its calls
into the library (`call_counts`), so a run can show that its path went
through the native code.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.decode.ngram import BOS, UNK

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LOCK_NAME = ".build.lock"

_lib = None
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_CALLS = {}

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_vp = ctypes.c_void_p


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def sources(src_dir: Path = SRC) -> list:
    """The library's sources: every .cc and the header they share."""
    return sorted([*src_dir.glob("*.cc"), *src_dir.glob("*.h")])


def build(src_dir: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile src_dir's .cc files into one shared library in build_dir,
    once per content of the sources, and return its path. The check, the
    compile and the move into place hold an flock on build_dir/LOCK_NAME,
    so of several processes that build at once one compiles and the
    others wait and load its library; the library is written under a
    temporary name and moved into place, so nothing ever loads a
    half-written file. Raises RuntimeError with the compiler's output if
    the build fails."""
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
    with open(build_dir / LOCK_NAME, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():        # built by the process that held the lock
            return lib
        tmp = build_dir / f".{lib.stem}.{os.getpid()}.so"
        res = subprocess.run(
            [cxx, *CXXFLAGS, "-o", str(tmp),
             *(str(s) for s in srcs if s.suffix == ".cc")],
            capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({res.returncode}) on "
                               f"{src_dir}:\n{res.stdout}{res.stderr}")
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
    c_f32, c_i64 = ctypes.c_float, ctypes.c_int64
    lib.a2p_ac_build.restype = _vp
    lib.a2p_ac_build.argtypes = [_i32p, _i32p, _f32p, c_i32]
    lib.a2p_ac_free.restype = None
    lib.a2p_ac_free.argtypes = [_vp]
    lib.a2p_ac_step.restype = c_f32
    lib.a2p_ac_step.argtypes = [_vp, _i32p, c_i32]
    lib.a2p_ac_final.restype = c_f32
    lib.a2p_ac_final.argtypes = [_vp, c_i32]
    lib.a2p_lmdec_create.restype = _vp
    lib.a2p_lmdec_create.argtypes = [
        c_i32, _i32p, _i32p, _i32p, c_i32, _i32p, _i32p, _f32p, _f32p,
        c_i64, c_i32, c_i32, c_f32, c_f32, c_i32, c_i32]
    lib.a2p_lmdec_free.restype = None
    lib.a2p_lmdec_free.argtypes = [_vp]
    lib.a2p_lmdec_clone.restype = _vp
    lib.a2p_lmdec_clone.argtypes = [_vp]
    lib.a2p_lmdec_set_bias.restype = None
    lib.a2p_lmdec_set_bias.argtypes = [_vp, _i32p, _i32p, _f32p, c_i32]
    lib.a2p_lmdec_decode.restype = c_i64
    lib.a2p_lmdec_decode.argtypes = [_vp, _f32p, c_i64, c_i32, _i32p, c_i32,
                                     _i32p, _i32p]
    lib.a2p_fst_load.restype = _vp
    lib.a2p_fst_load.argtypes = [ctypes.c_char_p]
    lib.a2p_fst_free.restype = None
    lib.a2p_fst_free.argtypes = [_vp]
    lib.a2p_fst_info.restype = None
    lib.a2p_fst_info.argtypes = [_vp, _i64p]
    lib.a2p_fst_transduce.restype = c_i64
    lib.a2p_fst_transduce.argtypes = [_vp, _i32p, c_i64, _i32p, c_i64]
    lib.a2p_tlg_new.restype = _vp
    lib.a2p_tlg_new.argtypes = [_vp, c_f32, c_i32, c_f32, c_f32, _vp]
    lib.a2p_tlg_free.restype = None
    lib.a2p_tlg_free.argtypes = [_vp]
    lib.a2p_tlg_start.restype = None
    lib.a2p_tlg_start.argtypes = [_vp]
    lib.a2p_tlg_step.restype = None
    lib.a2p_tlg_step.argtypes = [_vp, _f32p, c_i64]
    lib.a2p_tlg_partial.restype = c_i64
    lib.a2p_tlg_partial.argtypes = [_vp, _i32p, c_i64]
    lib.a2p_tlg_nbest.restype = c_i64
    lib.a2p_tlg_nbest.argtypes = [_vp, c_i32, _i32p, c_i64, _f32p]
    lib.a2p_edit_align.restype = c_i64
    lib.a2p_edit_align.argtypes = [_i32p, c_i64, _i32p, c_i64, _i32p, _i32p]


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


COUNTED = ("resample", "vad_chunk", "ctc_beam_decode", "ac_step",
           "lm_decode", "fst_transduce", "tlg_step", "tlg_partial",
           "tlg_nbest", "edit_align")


def call_counts() -> dict:
    """Calls into the library since the last reset, by function:
    `resample`, `vad_chunk` (one a chunk of one stream),
    `ctc_beam_decode` and `lm_decode` (one a segment), `ac_step`,
    `fst_transduce` (two an FstITN.normalize), `tlg_step` (one a row of
    log-probs), `tlg_partial` and `tlg_nbest` (one a TLG decode),
    `edit_align` (one a scored pair)."""
    with _count_lock:
        return {k: _CALLS.get(k, 0) for k in COUNTED}


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
# the Levenshtein alignment
# ---------------------------------------------------------------------------

def edit_align(a, b) -> Tuple[List[int], int]:
    """a2p_edit_align on two sequences of int32 symbol ids: (ops,
    distance), ops 0 = match, 1 = substitution, 2 = deletion, 3 =
    insertion, in order (tools/compute_wer.align's native branch)."""
    aa = np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
    bb = np.ascontiguousarray(b, dtype=np.int32).reshape(-1)
    ops = np.empty(len(aa) + len(bb) + 1, np.int32)
    dist = ctypes.c_int32(0)
    lib = library()
    _count("edit_align")
    n = lib.a2p_edit_align(_ptr(aa, _i32p), len(aa), _ptr(bb, _i32p),
                           len(bb), _ptr(ops, _i32p), ctypes.byref(dist))
    if not max(len(aa), len(bb)) <= n <= len(aa) + len(bb):
        raise RuntimeError(f"a2p_edit_align returned {n} ops for sequences "
                           f"of {len(aa)} and {len(bb)}")
    return ops[:n].tolist(), int(dist.value)


# ---------------------------------------------------------------------------
# the E2E VAD automaton
# ---------------------------------------------------------------------------

class _Handle:
    """A library object owned by one Python object: freed by close() (or
    when the object is collected), with a lock that makes close() safe
    against a call from another thread. `_live()` inside the lock gives
    the handle or raises once it is closed. Decoders that point into a
    handle (`_acquire`/`_release`) keep close() from freeing it under
    them."""

    _free = ""              # the library function that frees the handle
    _what = "handle"

    def _own(self, handle):
        self._lib = library()
        self._lock = threading.Lock()
        self._users = 0
        self._handle = None
        if not handle:
            raise RuntimeError(f"the native library did not create the "
                               f"{self._what}")
        self._handle = handle

    def _live(self):
        if self._handle is None:
            raise RuntimeError(f"the {self._what} was closed")
        return self._handle

    def _acquire(self):
        with self._lock:
            self._live()
            self._users += 1

    def _release(self):
        with self._lock:
            self._users -= 1

    def close(self):
        """Free the handle; later calls raise. Idempotent."""
        lock = getattr(self, "_lock", None)
        if lock is None:        # _own was not reached
            return
        with lock:
            if self._users:
                raise RuntimeError(f"the {self._what} is in use by "
                                   f"{self._users} decoder(s)")
            if self._handle:
                getattr(self._lib, self._free)(self._handle)
            self._handle = None

    def __del__(self):
        # a handle still in use is left to the collection of its users
        if not getattr(self, "_users", 0):
            self.close()


class NativeVad(_Handle):
    """E2E VAD decision automaton's per-frame loop (e2e_vad.cc), one
    instance per stream; vad/e2e_vad.E2EVadStateMachine keeps decibel
    extraction and the online segment emission in Python."""

    _free, _what = "a2p_vad_free", "VAD automaton"

    def __init__(self, opts):
        self._own(library().a2p_vad_new(
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
            int(opts.frame_in_ms)))
        self._seg_buf = np.empty(4, np.int32)

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


# ---------------------------------------------------------------------------
# the Aho-Corasick bias automaton
# ---------------------------------------------------------------------------

class NativeAcBias(_Handle):
    """Aho-Corasick bias automaton over int32 symbol ids (native.cc;
    bias-lm.cpp role): words are symbol sequences, each with a boost per
    symbol. States are ints (0 the root); step returns the score delta,
    negative when a partial match is retracted. A NativeTlgFstDecoder
    consults it on every emitting arc."""

    _free, _what = "a2p_ac_free", "bias automaton"

    def __init__(self, words: List[List[int]], scores: List[float]):
        if len(words) != len(scores) or not words:
            raise ValueError(f"bias automaton: {len(words)} words and "
                             f"{len(scores)} scores")
        flat = np.asarray([s for w in words for s in w], np.int32)
        lens = np.asarray([len(w) for w in words], np.int32)
        sc = np.asarray(scores, np.float32)
        self._own(library().a2p_ac_build(_ptr(flat, _i32p),
                                         _ptr(lens, _i32p), _ptr(sc, _f32p),
                                         len(words)))

    def step(self, state: int, symbol: int) -> Tuple[int, float]:
        s = ctypes.c_int32(state)
        with self._lock:
            handle = self._live()
            _count("ac_step")
            delta = self._lib.a2p_ac_step(handle, ctypes.byref(s),
                                          int(symbol))
        return s.value, float(delta)

    def final(self, state: int) -> float:
        with self._lock:
            return float(self._lib.a2p_ac_final(self._live(), int(state)))


# ---------------------------------------------------------------------------
# the LM beam decoder
# ---------------------------------------------------------------------------

class NativeLmDecoder(_Handle):
    """The lexicon-trie x backoff n-gram token passer (lm_decoder.cc),
    with an optional hotword bias; the native version of
    decode/lm_decoder.LmDecoder, which is its plain reference. It works
    on unit ids: build it with the acoustic vocabulary's token2id.

    The tables (trie and n-grams) are built once; clone() makes a decoder
    over the same tables (refcounted in the library) with its own bias,
    for a connection's hotwords. decode() keeps its search state local to
    the call, so one decoder may serve several threads.

    One difference from LmDecoder, as in the JAX package's native
    decoder: an out-of-lexicon unit sequence that spells a word of the LM
    missing from the lexicon scores as out-of-vocabulary here."""

    _free, _what = "a2p_lmdec_free", "LM decoder"
    SKIP_TOKENS = ("<s>", "</s>", "<blank>", "<unk>")
    MAX_ORDER = 8           # lm_decoder.cc kMaxOrder

    def __init__(self, lm, lexicon, token2id, lm_weight: float = 0.5,
                 beam: int = 16, am_topk: int = 8,
                 oov_penalty: float = -14.0,
                 hotwords: Optional[dict] = None,
                 context_score: float = 3.0):
        if not 1 <= lm.order <= self.MAX_ORDER:
            raise ValueError(f"LM decoder: order {lm.order} outside "
                             f"1..{self.MAX_ORDER}")
        word2id, id2word = {}, []

        def wid(w: str) -> int:
            i = word2id.get(w)
            if i is None:
                i = word2id[w] = len(id2word)
                id2word.append(w)
            return i

        unk_id, bos_id = wid(UNK), wid(BOS)
        # the lexicon trie as flat unit-id paths; a unit outside the
        # acoustic vocabulary makes its words unreachable
        lex_units, lex_lens, lex_words = [], [], []

        def walk(node, path):
            for key, sub in node.items():
                if key == "\0":
                    for word in sub:
                        lex_units.extend(path)
                        lex_lens.append(len(path))
                        lex_words.append(wid(word))
                elif key in token2id:
                    walk(sub, path + [token2id[key]])

        walk(lexicon.root, [])
        # the n-gram table: the union of probability and backoff keys, in
        # sorted order so that word ids do not depend on hashing
        ng_words, ng_lens, ng_logp, ng_bow = [], [], [], []
        nan = float("nan")
        for ng in sorted(set(lm.logp) | set(lm.backoff)):
            ng_words.extend(wid(w) for w in ng)
            ng_lens.append(len(ng))
            ng_logp.append(lm.logp.get(ng, nan))
            ng_bow.append(lm.backoff.get(ng, nan))
        a = [np.asarray(x, np.int32) for x in (lex_units, lex_lens,
                                               lex_words, ng_words, ng_lens)]
        f = [np.asarray(x, np.float32) for x in (ng_logp, ng_bow)]
        self._own(library().a2p_lmdec_create(
            int(lm.order), _ptr(a[0], _i32p), _ptr(a[1], _i32p),
            _ptr(a[2], _i32p), len(lex_lens), _ptr(a[3], _i32p),
            _ptr(a[4], _i32p), _ptr(f[0], _f32p), _ptr(f[1], _f32p),
            len(ng_lens), unk_id, bos_id, float(lm_weight),
            float(oov_penalty), int(beam), int(am_topk)))
        self._id2word = id2word
        self._token2id = token2id
        self._context_score = context_score
        self._skip = np.asarray([token2id[t] for t in self.SKIP_TOKENS
                                 if t in token2id], np.int32)
        self.hotwords = None
        if hotwords:
            self._attach_bias(hotwords)

    def _attach_bias(self, hotwords: dict):
        """The hotword trie over unit ids (context_graph.py's build: a
        boost per character of each token, the context score where a
        word has none); phrases with a unit outside the vocabulary are
        left out, as ContextGraph can never match them."""
        units, lens, scores = [], [], []
        for phrase, boost in hotwords.items():
            toks = ContextGraph._default_split(phrase)
            if not toks or any(t not in self._token2id for t in toks):
                continue
            per = float(boost) if boost else self._context_score
            units.extend(self._token2id[t] for t in toks)
            lens.append(len(toks))
            scores.extend(per * len(t) for t in toks)
        self.hotwords = dict(hotwords)
        if lens:
            u, n = np.asarray(units, np.int32), np.asarray(lens, np.int32)
            sc = np.asarray(scores, np.float32)
            with self._lock:
                self._lib.a2p_lmdec_set_bias(self._live(), _ptr(u, _i32p),
                                             _ptr(n, _i32p),
                                             _ptr(sc, _f32p), len(lens))

    def clone(self, hotwords: Optional[dict] = None) -> "NativeLmDecoder":
        """A decoder over this decoder's tables, O(1) in their size
        (FunASRWfstDecoderInit's share-the-graph contract,
        funasrruntime.cpp:836-894), biased by `hotwords`. Either may be
        closed first."""
        new = object.__new__(NativeLmDecoder)
        with self._lock:
            handle = self._lib.a2p_lmdec_clone(self._live())
        new._own(handle)
        new._id2word = self._id2word
        new._token2id = self._token2id
        new._context_score = self._context_score
        new._skip = self._skip
        new.hotwords = None
        if hotwords:
            new._attach_bias(hotwords)
        return new

    def start_utterance(self):
        """Nothing to reset: decode() keeps its state local."""

    def decode(self, log_probs: np.ndarray, id_to_token) -> str:
        """The best word sequence over [U, V] log-probability rows, one
        row a token; units off the lexicon come out as their text."""
        rows = np.ascontiguousarray(log_probs, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"LM decode takes [U, V] rows, got "
                             f"{rows.shape}")
        n, v = rows.shape
        out_u = np.empty(max(n, 1), np.int32)
        out_w = np.empty(max(n, 1), np.int32)
        with self._lock:
            handle = self._live()
            _count("lm_decode")
            m = self._lib.a2p_lmdec_decode(
                handle, _ptr(rows, _f32p), n, v, _ptr(self._skip, _i32p),
                len(self._skip), _ptr(out_u, _i32p), _ptr(out_w, _i32p))
        if not 0 <= m <= n:
            raise RuntimeError(f"a2p_lmdec_decode refused its input ({m}): "
                               f"{n} rows of {v}")
        parts, pending = [], []
        for t in range(int(m)):
            tok = id_to_token(int(out_u[t]))
            w = int(out_w[t])
            if w >= 0:
                parts.append(self._id2word[w])
                pending = []
            elif w == -2:           # an out-of-lexicon word ended here
                parts.append("".join(pending) + tok)
                pending = []
            else:
                pending.append(tok)
        # a dangling lexicon prefix comes out as its units
        return "".join(parts) + "".join(pending)


# ---------------------------------------------------------------------------
# OpenFST graphs and the TLG decoder
# ---------------------------------------------------------------------------

class NativeFst(_Handle):
    """An OpenFST file read by the library (fst.cc: vector and const
    StdArc FSTs, with or without symbol tables): a TLG.fst or the
    WeTextProcessing ITN grammars (com-define.h:76-80). `transduce` is
    compose(linear(input), fst) and the tropical shortest path
    (itn-processor.cpp:53-87). A file that cannot be read raises
    ValueError."""

    _free, _what = "a2p_fst_free", "FST"

    def __init__(self, path: str):
        handle = library().a2p_fst_load(os.fsencode(str(path)))
        if not handle:
            raise ValueError(f"cannot read OpenFST file: {path}")
        self._own(handle)
        self.path = str(path)
        info = np.zeros(3, np.int64)
        self._lib.a2p_fst_info(handle, _ptr(info, _i64p))
        self.start, self.num_states, self.num_arcs = (int(x) for x in info)

    def transduce(self, labels: List[int]) -> Tuple[bool, List[int]]:
        """(accepted, output labels): the best path's epsilon-free output
        for the input label sequence, and whether any path accepts it
        (when none does, the labels are [])."""
        inp = np.ascontiguousarray(labels, np.int32)
        # a tagger writes some 20 bytes a character; a longer output
        # takes one more search with four times the room
        cap = 32 * len(inp) + 256
        _count("fst_transduce")
        while True:
            out = np.empty(cap, np.int32)
            with self._lock:
                handle = self._live()
                n = self._lib.a2p_fst_transduce(handle, _ptr(inp, _i32p),
                                                len(inp), _ptr(out, _i32p),
                                                cap)
            if n == -2:             # the output did not fit
                cap *= 4
                continue
            if n == -1:
                return False, []
            if not 0 <= n <= cap:
                raise RuntimeError(f"a2p_fst_transduce returned {n}")
            return True, [int(x) for x in out[:n]]


class NativeTlgFstDecoder(_Handle):
    """Beam token passing over a decoding graph (tlg_decoder.cc;
    WfstDecoder role, wfst-decoder.cpp:27-92): one row of log-probs a
    step, indexed by the graph's input labels; an optional Aho-Corasick
    hotword bias (the SetBiasLm hook); the partial best path between
    steps; unique-final n-best. It holds per-utterance state, so one
    decoder serves one utterance at a time. The graph and the bias stay
    open while it lives."""

    _free, _what = "a2p_tlg_free", "TLG decoder"

    def __init__(self, fst: NativeFst, beam: float = 16.0,
                 max_active: int = 2000, ac_scale: float = 1.0,
                 lm_scale: float = 1.0,
                 bias: Optional[NativeAcBias] = None):
        with fst._lock, (bias._lock if bias is not None
                         else contextlib.nullcontext()):
            handle = library().a2p_tlg_new(
                fst._live(), float(beam), int(max_active), float(ac_scale),
                float(lm_scale), None if bias is None else bias._live())
        self._own(handle)
        self.fst, self.bias = fst, bias
        fst._acquire()
        if bias is not None:
            bias._acquire()
        self._steps = 0

    def close(self):
        had = getattr(self, "_handle", None) is not None
        super().close()
        if had:
            self.fst._release()
            if self.bias is not None:
                self.bias._release()

    def start_utterance(self):
        with self._lock:
            self._lib.a2p_tlg_start(self._live())
            self._steps = 0

    def step(self, logp_by_ilabel: np.ndarray):
        self.steps(np.asarray(logp_by_ilabel, np.float32)[None])

    def steps(self, rows: np.ndarray):
        """One step per row of [n, n_ilabels] log-probs."""
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"TLG steps take [n, ilabels] rows, got "
                             f"{rows.shape}")
        with self._lock:
            handle = self._live()
            for row in rows:
                _count("tlg_step")
                self._lib.a2p_tlg_step(handle, _ptr(row, _f32p), len(row))
            self._steps += len(rows)

    def _cap(self) -> int:
        return 64 + 4 * self._steps

    def partial(self) -> List[int]:
        """Word ids of the best live hypothesis (partial best path,
        wfst-decoder.cpp:27-57 role); call between steps."""
        cap = self._cap()
        while True:
            out = np.empty(cap, np.int32)
            with self._lock:
                handle = self._live()
                _count("tlg_partial")
                n = self._lib.a2p_tlg_partial(handle, _ptr(out, _i32p), cap)
            if n != -2:
                break
            cap *= 4
        if not 0 <= n <= cap:
            raise RuntimeError(f"a2p_tlg_partial returned {n}")
        return [int(x) for x in out[:n]]

    def nbest(self, n: int = 1) -> List[Tuple[List[int], float]]:
        """Up to n (word ids, cost) best-first, one per final token."""
        if n < 1:
            raise ValueError(f"nbest {n} < 1")
        cap = n * (self._cap() + 1)
        out = np.empty(cap, np.int32)
        scores = np.empty(n, np.float32)
        with self._lock:
            handle = self._live()
            _count("tlg_nbest")
            got = self._lib.a2p_tlg_nbest(handle, int(n), _ptr(out, _i32p),
                                          cap, _ptr(scores, _f32p))
        if not 0 <= got <= n:
            raise RuntimeError(f"a2p_tlg_nbest returned {got}")
        res, off = [], 0
        for i in range(int(got)):
            end = off
            while out[end] != -1:
                end += 1
            res.append(([int(x) for x in out[off:end]], float(scores[i])))
            off = end + 1
        return res
