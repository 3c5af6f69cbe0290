"""The port's native host library (asr2pass_tpu_torch/native) against the
JAX package's, on the CPU: the resampler, the E2E VAD automaton and the
pruned CTC prefix beam, and how the library is built. The LM, FST and TLG
parts are held in tests/test_torch_lm.py.

Each check runs the JAX package's native path and, where it has one, its
Python spec, as tests/test_native.py runs them. Inputs are made with
numpy from a seed. Tolerances: resampled audio, automaton events and
n-best ids and times exact; the native beam's scores within 1e-4 of the
Python spec's (the C++ beam sums in double and returns fp32), the numpy
resampler's interior within 2e-4 of the native one (JAX's own limit).
"""
import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from asr2pass_tpu.decode import ctc as jctc
from asr2pass_tpu.decode.context_graph import ContextGraph as JContextGraph
from asr2pass_tpu.frontend import audio as jaudio
from asr2pass_tpu.native import bindings as jnb
from asr2pass_tpu.runtime.sensevoice_asr import (
    _merge_candidates as j_merge_candidates)
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu.vad import e2e_vad as je2e
from asr2pass_tpu_torch.decode import ctc as tctc
from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.frontend import audio as taudio
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.runtime.sensevoice_asr import (_merge_candidates,
                                                       context_unit_ids)
from asr2pass_tpu_torch.vad import e2e_vad as te2e

REPO = Path(__file__).resolve().parents[1]
JAX_SRC = REPO / "asr2pass_tpu" / "native" / "src"
BEAM_SCORE_ATOL = 1e-4
RESAMPLE_INTERIOR_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's native library is the reference here: its
    absence is a failure, not a reason to compare with its Python."""
    assert jnb.available(), "the JAX package's native library did not build"


# -- the sources -------------------------------------------------------------

@pytest.mark.parametrize("name", ["native.cc", "ctc_beam.cc", "e2e_vad.cc",
                                  "lm_decoder.cc", "fst.cc",
                                  "tlg_decoder.cc", "api.h"])
def test_sources_are_copies(name):
    """Below its header line, each port source is the JAX file."""
    port = (tnb.SRC / name).read_text().splitlines()
    assert port[0].startswith("// Copy of the JAX package's native/src/")
    assert port[1:] == (JAX_SRC / name).read_text().splitlines()


def test_api_header_declares_only_the_three_files():
    """The library is the JAX package's six files: api.h (now the whole
    copy) declares only functions they define, the LM decoder's among
    them, and every function the bindings call is defined there."""
    declared = set(re.findall(r"\b(a2p_\w+)\s*\(",
                              (tnb.SRC / "api.h").read_text()))
    defined = set()
    for src in tnb.sources():
        if src.suffix == ".cc":
            defined |= set(re.findall(r"\b(a2p_\w+)\s*\(",
                                      src.read_text()))
    assert declared and declared <= defined
    assert "a2p_lmdec_decode" in declared
    called = set(re.findall(r"\b_?lib\w*\.(a2p_\w+)",
                            Path(tnb.__file__).read_text()))
    assert called and called <= defined
    assert sorted(p.name for p in tnb.sources()) == [
        "api.h", "ctc_beam.cc", "e2e_vad.cc", "fst.cc", "lm_decoder.cc",
        "native.cc", "tlg_decoder.cc"]


# -- the resampler -----------------------------------------------------------

_RATES = [(8000, 16000), (44100, 16000), (16000, 22050), (16000, 16000)]


def _audio(seed, n=12345):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("fs_in,fs_out", _RATES)
def test_resample_equals_jax_native(fs_in, fs_out):
    """The port's library against the JAX package's: equal arrays; and
    the port's default linear_resample against JAX's default."""
    x = _audio(fs_in + fs_out)
    got = tnb.resample(x, fs_in, fs_out)
    want = jnb.resample(x, fs_in, fs_out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio.linear_resample(x, fs_in, fs_out),
                                  jaudio.linear_resample(x, fs_in, fs_out))


@pytest.mark.parametrize("fs_in,fs_out", _RATES)
def test_resample_native_against_numpy(fs_in, fs_out):
    """The native resampler against the port's numpy path (the plain
    version): lengths within 1, the interior within 2e-4."""
    x = _audio(7 + fs_in)
    nat = taudio.linear_resample(x, fs_in, fs_out)
    plain = taudio.linear_resample(x, fs_in, fs_out, native=False)
    assert abs(len(nat) - len(plain)) <= 1
    n = min(len(nat), len(plain))
    sl = slice(100, n - 100)
    np.testing.assert_allclose(nat[sl], plain[sl],
                               atol=RESAMPLE_INTERIOR_ATOL)


def test_resample_counts_its_calls():
    tnb.reset_call_counts()
    taudio.linear_resample(_audio(1, 800), 8000, 16000)
    taudio.linear_resample(_audio(1, 800), 8000, 16000, native=False)
    taudio.linear_resample(_audio(1, 800), 16000, 16000)
    assert tnb.call_counts()["resample"] == 1


# -- the VAD automaton -------------------------------------------------------

def _vad_chunks(seed, n_chunks=50):
    """test_native.py's stream: bursty posteriors over 3 pdfs, speech
    louder than silence, finals at chunk 24 and at the end, per-call
    overrides on every seventh chunk."""
    rng = np.random.default_rng(seed)
    chunks = []
    for k in range(n_chunks):
        base = 0.05 if (k % 9) < 5 else 0.95
        scores = np.clip(base + rng.normal(0, 0.1, (64, 3)),
                         1e-4, 1 - 1e-4).astype(np.float32)
        amp = 0.2 if base < 0.5 else 0.01
        wav = rng.normal(0, amp, 64 * 160).astype(np.float32)
        fin = k in (24, n_chunks - 1)
        over = ({"max_end_sil": 500, "max_single_segment_time": 5000}
                if k % 7 == 3 else {})
        chunks.append((scores, wav, fin, over))
    return chunks


def _run_vad(sm, chunks, online):
    out = [sm(scores, wav, is_final=fin, online=online, **over)
           for scores, wav, fin, over in chunks]
    # reuse after a reset (FsmnVadStream.reset's call), mid-utterance
    sm._all_reset()
    out += [sm(scores, wav, is_final=fin, online=online, **over)
            for scores, wav, fin, over in chunks[:12]]
    return out


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_vad_automaton_matches_jax(seed, online, monkeypatch):
    """The port's native automaton (its default) against the JAX
    package's native automaton and its Python frame loop: equal events
    chunk by chunk, through finals, overrides and a reset."""
    chunks = _vad_chunks(seed)
    jnat = je2e.E2EVadStateMachine(je2e.VadOptions())
    assert jnat._native is not None
    monkeypatch.setenv("ASR2PASS_NATIVE_VAD", "0")
    jpy = je2e.E2EVadStateMachine(je2e.VadOptions())
    assert jpy._native is None
    port = te2e.E2EVadStateMachine(te2e.VadOptions())
    assert port._native is not None
    got = _run_vad(port, chunks, online)
    assert got == _run_vad(jnat, chunks, online)
    assert got == _run_vad(jpy, chunks, online)
    assert any(got)


def test_vad_automaton_counts_and_closes():
    """One library call a chunk; a closed automaton raises instead of
    touching its freed handle; the plain path has nothing to free."""
    sm = te2e.E2EVadStateMachine(te2e.VadOptions())
    chunks = _vad_chunks(0, 5)
    tnb.reset_call_counts()
    for scores, wav, fin, over in chunks:
        sm(scores, wav, is_final=fin, **over)
    assert tnb.call_counts()["vad_chunk"] == len(chunks)
    sm.close()
    sm.close()
    with pytest.raises(RuntimeError, match="closed"):
        sm(*chunks[0][:2])
    plain = te2e.E2EVadStateMachine(te2e.VadOptions(), native=False)
    plain.close()
    assert isinstance(plain(*chunks[0][:2]), list)


# -- the CTC prefix beam -----------------------------------------------------

_VOCAB = make_test_vocab(64)


def _hotwords():
    t = _VOCAB.id2token
    return {t(7) + t(9): None, t(7) + t(11) + t(12): 5.0}


def _prune(logits, k):
    """Top-k ids and log-probs of each row of [T, V] logits."""
    x = logits.astype(np.float64)
    logp = (x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - x.max(-1, keepdims=True)).astype(np.float32)
    ids = np.argsort(-logp, axis=-1, kind="stable")[:, :k].astype(np.int32)
    return ids, np.take_along_axis(logp, ids, -1)


def _assert_same_nbest(got, want):
    assert [h[0] for h in got] == [h[0] for h in want]
    assert [h[2] for h in got] == [h[2] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want],
                               atol=BEAM_SCORE_ATOL)


@pytest.mark.parametrize("with_context", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_beam_matches_jax_spec(seed, with_context):
    """The port's native n-best (its default) against the JAX package's
    Python spec on the same pruned candidates (T=18, V=64, K=12, beam
    6), with and without a context graph."""
    rng = np.random.default_rng(seed)
    cid, clp = _prune(rng.standard_normal((18, 64)).astype(np.float32) * 2.5,
                      12)
    ctx = ContextGraph(context_score=3.0).build(_hotwords()) \
        if with_context else None
    jctx = JContextGraph(context_score=3.0).build(_hotwords()) \
        if with_context else None
    got = tctc.ctc_prefix_beam_search_pruned(
        cid, clp, 18, beam=6, context=ctx, token2id=_VOCAB.token2id)
    want = jctc.ctc_prefix_beam_search_pruned(
        cid, clp, 18, beam=6, context=jctx, id_to_token=_VOCAB.id2token,
        use_native=False)
    assert got
    _assert_same_nbest(got, want)


@pytest.mark.parametrize("shape", ["T0", "T1", "K1", "beam_gt_K",
                                   "duplicates"])
def test_beam_edge_shapes_match_jax_spec(shape):
    """Empty and one-frame utterances, one candidate a frame, a beam
    wider than the candidates, duplicate ids in a frame."""
    rng = np.random.default_rng(3)
    if shape == "T0":
        cid, clp, t, beam = (np.zeros((1, 1), np.int32),
                             np.zeros((1, 1), np.float32), 0, 1)
    elif shape == "T1":
        cid, clp = _prune(rng.standard_normal((1, 64)).astype(np.float32),
                          8)
        t, beam = 1, 4
    elif shape == "K1":
        cid, clp = _prune(rng.standard_normal((9, 64)).astype(np.float32),
                          1)
        t, beam = 9, 3
    elif shape == "beam_gt_K":
        cid, clp = _prune(rng.standard_normal((7, 64)).astype(np.float32)
                          * 3, 3)
        t, beam = 7, 10
    else:
        cid = rng.integers(0, 6, (8, 6)).astype(np.int32)
        clp = (rng.standard_normal((8, 6)) - 1).astype(np.float32)
        t, beam = 8, 4
    ctx = ContextGraph(context_score=3.0).build(_hotwords())
    jctx = JContextGraph(context_score=3.0).build(_hotwords())
    for c, jc in ((None, None), (ctx, jctx)):
        got = tctc.ctc_prefix_beam_search_pruned(
            cid, clp, t, beam=beam, context=c, token2id=_VOCAB.token2id)
        want = jctc.ctc_prefix_beam_search_pruned(
            cid, clp, t, beam=beam, context=jc,
            id_to_token=_VOCAB.id2token, use_native=False)
        assert got
        _assert_same_nbest(got, want)


def test_beam_hotword_outside_topk():
    """The serving combination: the prune hides a hotword unit, the
    merged candidates (_merge_candidates) bring it back, and the native
    beam takes the hotword, as JAX's Python spec does."""
    logp = np.full((2, 64), -12.0, np.float32)
    logp[0, 4] = -0.01
    logp[1, 6] = -0.40
    for j, tok in enumerate(range(20, 30)):
        logp[1, tok] = -0.60 - 0.001 * j
    logp[1, 5] = -0.80
    hot = {_VOCAB.id2token(4) + _VOCAB.id2token(5): None}
    ctx = ContextGraph(context_score=3.0).build(hot)
    jctx = JContextGraph(context_score=3.0).build(hot)
    cid = np.argsort(-logp, axis=-1, kind="stable")[:, :8].astype(np.int32)
    clp = np.take_along_axis(logp, cid, -1)
    hw_ids = context_unit_ids(ctx, _VOCAB.token2id)
    assert 5 in hw_ids and 5 not in cid[1]
    mid, mlp = _merge_candidates(cid, clp, hw_ids, logp[:, hw_ids])
    jmid, jmlp = j_merge_candidates(cid, clp, hw_ids, logp[:, hw_ids])
    np.testing.assert_array_equal(mid, jmid)
    got = tctc.ctc_prefix_beam_search_pruned(
        mid, mlp, 2, beam=4, context=ctx, token2id=_VOCAB.token2id)
    want = jctc.ctc_prefix_beam_search_pruned(
        jmid, jmlp, 2, beam=4, context=jctx, id_to_token=_VOCAB.id2token,
        use_native=False)
    assert got[0][0] == [4, 5]
    _assert_same_nbest(got, want)


def test_beam_refuses_instead_of_falling_back():
    """A context without token2id, shapes the library does not take and
    an input it refuses each raise; nothing returns None."""
    cid, clp = _prune(np.random.default_rng(0).standard_normal(
        (4, 64)).astype(np.float32), 4)
    ctx = ContextGraph(context_score=3.0).build(_hotwords())
    with pytest.raises(ValueError, match="token2id"):
        tctc.ctc_prefix_beam_search_pruned(cid, clp, 4, context=ctx)
    with pytest.raises(ValueError, match=r"\[T, K\]"):
        tnb.ctc_beam_decode(cid, clp[:, :2], 4)
    with pytest.raises(RuntimeError, match="refused"):
        tnb.ctc_beam_decode(cid[:, :0], clp[:, :0], 4)
    tnb.reset_call_counts()
    assert tctc.ctc_prefix_beam_search_pruned(
        cid, clp, 4, context=ctx, token2id=_VOCAB.token2id) is not None
    assert tnb.call_counts()["ctc_beam_decode"] == 1
    # the trie is serialized once per (graph, token2id)
    trie = ctx._a2p_trie
    tctc.ctc_prefix_beam_search_pruned(cid, clp, 4, context=ctx,
                                       token2id=_VOCAB.token2id)
    assert ctx._a2p_trie is trie


# -- the build ---------------------------------------------------------------

_BUILD_AND_CALL = r"""
import sys
import numpy as np
from pathlib import Path
from asr2pass_tpu_torch.native import bindings as nb
sys.stdin.readline()                # start together
lib = nb.build(nb.SRC, Path(sys.argv[1]))
nb.BUILD_DIR = Path(sys.argv[1])
out = nb.resample(np.ones(800, np.float32), 8000, 16000)
print(lib, len(out))
"""


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes that build into an empty directory at once both
    load the same library, and no temporary file is left."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_CALL, str(tmp_path)], cwd=REPO,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o.split() for o, _ in outs]
    assert lines[0] == lines[1] and lines[0][1] == "1600"
    # the library and the build's lock file, no temporary
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(lines[0][0]).name, tnb.LOCK_NAME])


_LOCKED_BUILD = r"""
import subprocess
import sys
from pathlib import Path
from asr2pass_tpu_torch.native import bindings as nb
compiles = []
run = subprocess.run

def counted(cmd, *a, **kw):
    compiles.append(cmd[0])
    return run(cmd, *a, **kw)

nb.subprocess.run = counted
sys.stdin.readline()                # start together
lib = nb.build(nb.SRC, Path(sys.argv[1]))
print(lib.name, len(compiles))
"""


def test_locked_build_compiles_once(tmp_path):
    """Two processes that build into an empty directory at once: the
    lock lets one compile, and the other waits and loads its library
    without compiling."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOCKED_BUILD, str(tmp_path)], cwd=REPO,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names, counts = zip(*(o.split() for o, _ in outs))
    assert names[0] == names[1]
    assert sorted(int(c) for c in counts) == [0, 1]


def test_broken_source_raises_with_the_log(tmp_path):
    """A source that does not compile raises RuntimeError carrying
    g++'s error; nothing is loaded or returned."""
    src = tmp_path / "src"
    shutil.copytree(tnb.SRC, src)
    with open(src / "ctc_beam.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnb.build(src, tmp_path / "build")
    assert "ctc_beam.cc" in str(err.value) and "error" in str(err.value)
    # nothing but the build's lock file
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        tnb.LOCK_NAME]


@pytest.mark.parametrize("name", ["lm_decoder.cc", "fst.cc",
                                  "tlg_decoder.cc"])
def test_broken_lm_source_raises(tmp_path, name):
    """The same for the LM, FST and TLG sources (each alone with the
    header, so that g++ stops at it): g++'s error, no library."""
    src = tmp_path / "src"
    src.mkdir()
    for f in (name, "api.h"):
        shutil.copy(tnb.SRC / f, src / f)
    with open(src / name, "a") as f:
        f.write("\nnot C++ either;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnb.build(src, tmp_path / "build")
    assert name in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("path", [
    "asr2pass_tpu_torch/native/bindings.py",
    "asr2pass_tpu_torch/decode/ctc.py",
    "asr2pass_tpu_torch/decode/tlg.py",
    "asr2pass_tpu_torch/decode/lm_decoder.py",
    "asr2pass_tpu_torch/frontend/audio.py",
    "asr2pass_tpu_torch/vad/e2e_vad.py"])
def test_no_fallback_in_source(path):
    """No try/except and no `return None` in the bindings and in the
    modules that call them: a failure raises to the caller."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        assert not isinstance(node, ast.Try), (path, node.lineno)
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Constant):
            assert node.value.value is not None, (path, node.lineno)


# -- the serving pattern from several threads --------------------------------

STRESS_SECONDS = 3.0
STRESS_LIMIT_S = 60.0       # the test's own time limit


def test_serving_pattern_from_many_threads(tmp_path):
    """The host pattern of the LM server (chip_smoke phase 10c) from
    several threads at once: one TlgDecoder per connection over one
    shared graph (biased for every other one), stepped in chunks with
    partials between, n-best at the end, FstITN on its text, then closed
    (or dropped, for the collector to free in whatever thread) and
    reopened; one decoder on long uploads; FstITN alone; NativeLmDecoder
    clones made, used and closed beside the shared base; a thread that
    runs the collector. Nothing may raise, every worker must get work
    done within the test's own time limit, and afterwards no decoder may
    hold the graph (so the graph closes)."""
    import gc
    import threading
    import time

    from asr2pass_tpu_torch.decode.lm_decoder import Lexicon
    from asr2pass_tpu_torch.decode.ngram import NgramLM
    from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
    from asr2pass_tpu_torch.text.itn import FstITN
    from torch_parity import lm_test_dirs

    d = lm_test_dirs(tmp_path)
    vocab = make_test_vocab(64)
    tok = vocab.token2id
    graph = TlgGraph(d["tlg"], tok)
    itn = FstITN(d["itn"] + "/zh_itn_tagger.fst",
                 d["itn"] + "/zh_itn_verbalizer.fst")
    base = tnb.NativeLmDecoder(NgramLM.load_arpa(d["arpa"] + "/lm.arpa"),
                               Lexicon.from_file(d["arpa"] + "/lexicon.txt"),
                               tok)
    words = [w for w in graph.word_syms if len(w) > 1 and w[0] != "<"]
    units = vocab.tokens[4:]
    stop = time.perf_counter() + STRESS_SECONDS
    errors, done = [], {}

    def rows(rng, n, width):
        x = rng.standard_normal((n, width)) * 3
        x -= x.max(-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))
                ).astype(np.float32)

    def worker(name):
        def wrap(fn):
            def run():
                try:
                    done[name] = fn(np.random.default_rng(
                        [ord(c) for c in name]))
                except Exception as e:      # noqa: BLE001 - reported below
                    errors.append(f"{name}: {e!r}")
            return threading.Thread(target=run, name=name)
        return wrap

    def connection(k):
        def run(rng):
            n = 0
            while time.perf_counter() < stop:
                dec = TlgDecoder(graph, tok, hotwords=(
                    {w: 10 for w in words[k: k + 3]} if k % 2 == 0 else None))
                for _ in range(2):
                    dec.start_utterance()
                    for _ in range(3):
                        dec.accept_ilabel_rows(rows(rng, 8, len(graph.gather)))
                        dec.partial_text()
                    best = dec.nbest(2)
                    itn.normalize((best[0][0] if best else "") + "，"
                                  + "".join(rng.choice(units, 5)))
                    n += 1
                if k % 3:
                    dec.close()
                del dec                 # k % 3 == 0: the collector frees it
            return n
        return run

    def upload(rng):
        dec, n = TlgDecoder(graph, tok), 0
        while time.perf_counter() < stop:
            dec.start_utterance()
            dec.decode_ilabel_rows(rows(rng, 300, len(graph.gather)))
            n += 1
        dec.close()
        return n

    def itn_only(rng):
        n = 0
        while time.perf_counter() < stop:
            itn.normalize("".join(rng.choice(units, 40)))
            n += 1
        return n

    def lm_clones(rng):
        n = 0
        while time.perf_counter() < stop:
            c = base.clone({w: 5 for w in words[:4]})
            c.decode(rows(rng, 30, len(vocab.tokens)), vocab.id2token)
            base.decode(rows(rng, 30, len(vocab.tokens)), vocab.id2token)
            c.close()
            n += 1
        return n

    def collector(rng):
        n = 0
        while time.perf_counter() < stop:
            gc.collect()
            time.sleep(0.01)
            n += 1
        return n

    threads = [worker(f"conn{k}")(connection(k)) for k in range(4)]
    threads += [worker(f.__name__)(f)
                for f in (upload, itn_only, lm_clones, collector)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, t0 + STRESS_LIMIT_S - time.perf_counter()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"still running after {STRESS_LIMIT_S} s: {alive}"
    assert not errors, errors
    assert len(done) == len(threads) and all(done.values()), done
    gc.collect()
    assert graph.fst._users == 0
    graph.fst.close()
    itn.tagger.close()
    itn.verbalizer.close()
    base.close()
