"""The port's n-gram LM, TLG graphs, FST reader and FST ITN against the
JAX package's, on the CPU: what the build tools write, what the readers
take and refuse, what the decoders return, and the refusals that replace
the JAX package's silent fallbacks.

Inputs are made with numpy from a seed (tests/torch_parity.lm_corpus,
lm_rows); the JAX package's native library is the reference for the
native decoders, its Python LmDecoder for the port's Python one. Files
written by the tools must be equal byte for byte; texts, word ids and
n-best lists equal; TLG n-best costs equal in fp32 (the same C++ on the
same rows).
"""
import ast
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from asr2pass_tpu.decode import fst_io as jfst_io
from asr2pass_tpu.decode import ngram as jngram
from asr2pass_tpu.decode.context_graph import ContextGraph as JContextGraph
from asr2pass_tpu.decode.lm_decoder import Lexicon as JLexicon
from asr2pass_tpu.decode.lm_decoder import LmDecoder as JLmDecoder
from asr2pass_tpu.decode.tlg import TlgDecoder as JTlgDecoder
from asr2pass_tpu.native import bindings as jnb
from asr2pass_tpu.text import itn as jitn
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu.tools import build_lm as jbuild_lm
from asr2pass_tpu.tools import build_tlg as jbuild_tlg
from asr2pass_tpu_torch.decode import fst_io, ngram
from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.decode.lm_decoder import Lexicon, LmDecoder
from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.text import itn as titn
from asr2pass_tpu_torch.tools import build_lm, build_tlg
from test_fst_golden import (GOLD_ARCS, GOLD_FINALS, INF, _const_body,
                             _header, _s, _symtab, _vector_body)
from torch_parity import lm_corpus, lm_rows

REPO = Path(__file__).resolve().parents[1]
VOCAB = make_test_vocab(64)
UNITS = VOCAB.tokens[4:]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    assert jnb.available(), "the JAX package's native library did not build"


def _lms(seed, order=3):
    sents = lm_corpus(UNITS, seed)
    return (ngram.NgramLM.train(sents, order=order),
            jngram.NgramLM.train(sents, order=order), sents)


def _word_units(lm):
    return {w: list(w) for w in lm.vocab if not w.startswith("<")}


# -- what the tools write ----------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_arpa_equals_jax(tmp_path, order):
    """train -> save_arpa writes JAX's bytes; load_arpa reads back JAX's
    tables and scores; interpolate gives JAX's tables."""
    lm, jlm, sents = _lms(order, order)
    lm.save_arpa(str(tmp_path / "p.arpa"))
    jlm.save_arpa(str(tmp_path / "j.arpa"))
    assert (tmp_path / "p.arpa").read_bytes() == \
        (tmp_path / "j.arpa").read_bytes()
    back = ngram.NgramLM.load_arpa(str(tmp_path / "p.arpa"))
    jback = jngram.NgramLM.load_arpa(str(tmp_path / "j.arpa"))
    assert (back.order, back.logp, back.backoff, back.vocab) == (
        jback.order, jback.logp, jback.backoff, jback.vocab)
    for s in sents[:5]:
        assert back.sentence_logp(s) == jback.sentence_logp(s)
    other, jother, _ = _lms(order + 10, 2)
    mix = ngram.interpolate(lm, other, 0.3)
    jmix = jngram.interpolate(jlm, jother, 0.3)
    assert (mix.order, mix.logp, mix.backoff, mix.vocab) == (
        jmix.order, jmix.logp, jmix.backoff, jmix.vocab)


@pytest.mark.parametrize("char_level", [False, True])
def test_build_lm_cli_equals_jax(tmp_path, char_level):
    """tools/build_lm on one corpus file: JAX's lm.arpa and lexicon.txt,
    byte for byte, with --interpolate too."""
    sents = lm_corpus(UNITS, 5)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(" ".join(s) for s in sents) + "\nab cd\n",
                      encoding="utf-8")
    extra = ["--char-level"] if char_level else []
    for name, mod in (("p", build_lm), ("j", jbuild_lm)):
        assert mod.main([str(corpus), str(tmp_path / name), "--order", "2",
                         *extra]) == 0
        assert mod.main([str(corpus), str(tmp_path / f"{name}i"),
                         "--interpolate", str(tmp_path / name / "lm.arpa"),
                         "--weight", "0.7", *extra]) == 0
    for sub in ("", "i"):
        for f in ("lm.arpa", "lexicon.txt"):
            assert (tmp_path / f"p{sub}" / f).read_bytes() == \
                (tmp_path / f"j{sub}" / f).read_bytes()


@pytest.mark.parametrize("ctc_blank", [None, "<blank>"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_build_tlg_equals_jax(tmp_path, order, ctc_blank):
    """build_tlg of one LM and lexicon writes JAX's TLG.fst, words.txt
    and tokens.txt byte for byte, in both topologies, through the
    function and through the command line."""
    lm, jlm, _ = _lms(20 + order, order)
    build_tlg.build_tlg(lm, _word_units(lm), str(tmp_path / "p"),
                        ctc_blank=ctc_blank)
    jbuild_tlg.build_tlg(jlm, _word_units(jlm), str(tmp_path / "j"),
                         ctc_blank=ctc_blank)
    lm.save_arpa(str(tmp_path / "lm.arpa"))
    lex = tmp_path / "lexicon.txt"
    lex.write_text("".join(f"{w} {' '.join(u)}\n"
                           for w, u in sorted(_word_units(lm).items())),
                   encoding="utf-8")
    blank = ["--ctc-blank", ctc_blank] if ctc_blank else []
    for name, mod in (("pc", build_tlg), ("jc", jbuild_tlg)):
        assert mod.main(["--arpa", str(tmp_path / "lm.arpa"), "--lexicon",
                         str(lex), "--out", str(tmp_path / name),
                         *blank]) == 0
    for a, b in (("p", "j"), ("pc", "jc")):
        for f in ("TLG.fst", "words.txt", "tokens.txt"):
            assert (tmp_path / a / f).read_bytes() == \
                (tmp_path / b / f).read_bytes(), (a, f)
    graph = TlgGraph(str(tmp_path / "p"), VOCAB.token2id)
    assert graph.is_ctc("<blank>") is (ctc_blank is not None)
    assert graph.fst.num_arcs > 0


# -- what the readers take and refuse ----------------------------------------

def _golden(kind):
    if kind == "vector":
        return _header("vector", 2, 0, 0, 3, 3) + _vector_body()
    if kind == "vector_syms":
        return (_header("vector", 2, 0x3, 0, 3, 3)
                + _symtab("isyms", ["<eps>", "one", "two", "three"])
                + _symtab("osyms", ["<eps>", "TEN", "TWENTY", "THIRTY"])
                + _vector_body())
    hdr = {"const_v2": _header("const", 2, 0, 0, 3, 3),
           "const_v1": _header("const", 1, 0x4, 0, 3, 3),
           "const_syms": _header("const", 1, 0x4 | 0x3, 0, 3, 3)
           + _symtab("i", ["<eps>", "x", "y", "z"]) + _symtab("o", ["<eps>"]),
           "const64": _header("const64", 1, 0x4, 0, 3, 3)}[kind]
    return hdr + _const_body(aligned=kind != "const_v2",
                             wide=kind == "const64", hdr_len=len(hdr))


def _jax_transduce(nf, labels):
    out = nf.transduce(labels)
    return (out is not None, out or [])


@pytest.mark.parametrize("kind", ["vector", "vector_syms", "const_v2",
                                  "const_v1", "const_syms", "const64"])
def test_golden_fsts_read_as_jax(tmp_path, kind):
    """tests/test_fst_golden.py's hand-assembled images: the port's
    NativeFst reads each as JAX's does, with the same shortest paths; the
    Python reader reads the vector ones as JAX's."""
    path = tmp_path / f"{kind}.fst"
    path.write_bytes(_golden(kind))
    nf, jf = tnb.NativeFst(str(path)), jnb.NativeFst(str(path))
    assert (nf.start, nf.num_states, nf.num_arcs) == (
        jf.start, jf.num_states, jf.num_arcs) == (0, 3, 3)
    for labels in ([1, 2], [3], [2], [], [1, 2, 2]):
        assert nf.transduce(labels) == _jax_transduce(jf, labels)
    assert nf.transduce([1, 2]) == (True, [10, 20])
    assert nf.transduce([2]) == (False, [])
    if kind.startswith("vector"):
        assert fst_io.read_fst(str(path)) == jfst_io.read_fst(str(path)) \
            == (0, [a for _, a in GOLD_ARCS], GOLD_FINALS)


def _bad_images():
    full = _header("vector", 2, 0, 0, 3, 3) + _vector_body()
    arc = (struct.pack("<f", INF) + struct.pack("<q", 1)
           + struct.pack("<iifi", 1, 1, 0.0, 77))
    out = {"magic": b"\x00\x01\x02\x03" + b"junk" * 10,
           "huge": _header("vector", 2, 0, 0, 1 << 40, 1 << 50),
           "negative": _header("vector", 2, 0, 0, -5, -1),
           "start": _header("vector", 2, 0, 99, 3, 3) + _vector_body(),
           "arc_target": _header("vector", 2, 0, 0, 1, 1) + arc,
           "symtab": _header("vector", 2, 0x1, 0, 3, 3)
           + struct.pack("<i", 1234) + _s("x") + _vector_body()}
    for cut in (4, 9, 17, 30):
        out[f"header_cut{cut}"] = _header("vector", 2, 0, 0, 3, 3)[:cut]
    for cut in (len(full) - 3, len(full) - 17, len(full) // 2):
        out[f"body_cut{cut}"] = full[:cut]
    return out


def _reads(cls, path):
    try:
        cls(str(path))
        return True
    except (ValueError, OSError):
        return False


@pytest.mark.parametrize("name", list(_bad_images()))
def test_malformed_fsts_rejected_as_jax(tmp_path, name):
    """Each malformed image of tests/test_fst_golden.py: the port's
    NativeFst raises ValueError, as JAX's does."""
    path = tmp_path / "bad.fst"
    path.write_bytes(_bad_images()[name])
    assert not _reads(jnb.NativeFst, path)
    with pytest.raises(ValueError, match="cannot read OpenFST"):
        tnb.NativeFst(str(path))


def test_fuzzed_fsts_read_as_jax(tmp_path):
    """test_fst_golden's fuzz: 50 images with flipped bytes; the port
    accepts exactly the ones JAX accepts, with the same paths."""
    rng = np.random.default_rng(0)
    hdr = _header("vector", 2, 0, 0, 3, 3)
    for i in range(50):
        blob = bytearray(hdr + _vector_body())
        for _ in range(rng.integers(1, 8)):
            blob[int(rng.integers(4, len(blob)))] = int(rng.integers(0, 256))
        path = tmp_path / f"fuzz{i}.fst"
        path.write_bytes(bytes(blob))
        ok = _reads(jnb.NativeFst, path)
        assert _reads(tnb.NativeFst, path) is ok
        if ok:
            assert tnb.NativeFst(str(path)).transduce([1, 2]) == \
                _jax_transduce(jnb.NativeFst(str(path)), [1, 2])


def test_python_reader_refuses_as_jax(tmp_path):
    """read_fst raises where JAX's raises, with the same message."""
    for name, blob in _bad_images().items():
        path = tmp_path / f"{name}.fst"
        path.write_bytes(blob)
        errs = []
        for reader in (fst_io.read_fst, jfst_io.read_fst):
            try:
                reader(str(path))
                errs.append(None)
            except (ValueError, struct.error) as e:
                errs.append((type(e), str(e)))
        assert errs[0] == errs[1], name


def test_fst_builder_roundtrip_equals_jax(tmp_path):
    """FstBuilder writes JAX's bytes; both readers read them back."""
    files = []
    for name, mod in (("p", fst_io), ("j", jfst_io)):
        b = mod.FstBuilder()
        end = b.add_string(b.start, [1, 2, 3], [7, 0, 9], w=0.25)
        b.set_final(end, 0.5)
        b.add_arc(end, 0, 4, -1.5, b.start)
        b.write(str(tmp_path / f"{name}.fst"))
        files.append((tmp_path / f"{name}.fst").read_bytes())
    assert files[0] == files[1]
    assert fst_io.read_fst(str(tmp_path / "p.fst")) == \
        jfst_io.read_fst(str(tmp_path / "j.fst"))


# -- the LM decoders ---------------------------------------------------------

def _hotwords(lm):
    words = sorted(w for w in lm.vocab if not w.startswith("<"))
    return {words[0] + words[1]: 4.0, words[2]: None}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_lm_decoders_match_jax(seed, bias):
    """On the same rows: the port's NativeLmDecoder gives JAX's native
    text, the port's LmDecoder JAX's Python text, and the two agree
    (the lexicon spells every LM word, so the native decoder's one
    difference does not arise); with a hotword bias too."""
    lm, jlm, _ = _lms(seed)
    lex = Lexicon.from_words(w for w in lm.vocab if not w.startswith("<"))
    jlex = JLexicon.from_words(w for w in jlm.vocab
                               if not w.startswith("<"))
    hot = _hotwords(lm) if bias else None
    nat = tnb.NativeLmDecoder(lm, lex, VOCAB.token2id, lm_weight=0.8,
                              hotwords=hot)
    jnat = jnb.NativeLmDecoder(jlm, jlex, VOCAB.token2id, lm_weight=0.8,
                               hotwords=hot)
    py = LmDecoder(lm, lex, lm_weight=0.8,
                   bias=ContextGraph().build(hot) if bias else None)
    jpy = JLmDecoder(jlm, jlex, lm_weight=0.8,
                     bias=JContextGraph().build(hot) if bias else None)
    changed = 0
    for k in range(3):
        rows = lm_rows(64, 10 + 3 * k, 100 * seed + k)
        got = nat.decode(rows, VOCAB.id2token)
        assert got == jnat.decode(rows, VOCAB.id2token)
        assert py.decode(rows, VOCAB.id2token) == got
        assert jpy.decode(rows, VOCAB.id2token) == got
        greedy = VOCAB.to_string([int(i) for i in rows.argmax(-1)
                                  if i >= 4])
        changed += got != greedy
    assert changed


def test_lm_clone_matches_a_fresh_decoder():
    """clone(hotwords) decodes as a NativeLmDecoder built with those
    hotwords and as JAX's clone; the base and the clone free apart; a
    closed decoder raises; calls are counted."""
    lm, jlm, _ = _lms(7)
    words = [w for w in lm.vocab if not w.startswith("<")]
    lex, jlex = Lexicon.from_words(words), JLexicon.from_words(words)
    hot = _hotwords(lm)
    base = tnb.NativeLmDecoder(lm, lex, VOCAB.token2id, lm_weight=0.8)
    fresh = tnb.NativeLmDecoder(lm, lex, VOCAB.token2id, lm_weight=0.8,
                                hotwords=hot)
    jclone = jnb.NativeLmDecoder(jlm, jlex, VOCAB.token2id,
                                 lm_weight=0.8).clone(hot)
    clone = base.clone(hot)
    tnb.reset_call_counts()
    for k in range(4):
        rows = lm_rows(64, 12, 900 + k)
        want = fresh.decode(rows, VOCAB.id2token)
        assert clone.decode(rows, VOCAB.id2token) == want
        assert jclone.decode(rows, VOCAB.id2token) == want
    assert tnb.call_counts()["lm_decode"] == 8
    base.close()
    rows = lm_rows(64, 12, 900)
    assert clone.decode(rows, VOCAB.id2token) == \
        fresh.decode(rows, VOCAB.id2token)
    with pytest.raises(RuntimeError, match="closed"):
        base.decode(rows, VOCAB.id2token)
    with pytest.raises(RuntimeError, match="closed"):
        base.clone()
    clone.close()
    clone.close()


# -- the TLG decoder ---------------------------------------------------------

def _graphs(tmp_path, seed, ctc_blank=None, order=2):
    lm, jlm, _ = _lms(seed, order)
    build_tlg.build_tlg(lm, _word_units(lm), str(tmp_path / "g"),
                        ctc_blank=ctc_blank)
    return lm, str(tmp_path / "g")


@pytest.mark.parametrize("ctc", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_tlg_decoder_matches_jax(tmp_path, seed, ctc):
    """One graph, one set of rows, fed in three chunks: the port's
    partials after each chunk, its n-best (texts and costs) and its
    text equal JAX's TlgDecoder's; with hotwords too. Rows gathered
    by gather_rows equal JAX's host gather."""
    lm, gdir = _graphs(tmp_path, 30 + seed, "<blank>" if ctc else None)
    hot = {w: 6.0 for w in sorted(_word_units(lm))[:2]}
    graph = TlgGraph(gdir, VOCAB.token2id)
    for hw in (None, hot):
        dec = TlgDecoder(graph, VOCAB.token2id, lm_weight=0.7, hotwords=hw)
        jdec = JTlgDecoder(gdir, VOCAB.token2id, lm_weight=0.7, hotwords=hw)
        rows = lm_rows(64, 18, 50 + seed)
        dec.start_utterance()
        jdec.start_utterance()
        for part in np.array_split(rows, 3):
            dec.accept_rows(part)
            jdec.accept_rows(part)
            assert dec.partial_text() == jdec.partial_text()
        got, want = dec.nbest(4), [
            ("".join(jdec.id2word.get(w, "") for w in ids), c)
            for ids, c in jdec._dec.nbest(4)]
        assert got == want and got
        for d in (dec, jdec):
            d.start_utterance()
        text = dec.decode(rows)
        assert text == jdec.decode(rows) and text
        ilabel = graph.gather_rows(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(ilabel, jdec._rows_to_ilabel(rows))
        dec.start_utterance()
        assert dec.decode_ilabel_rows(ilabel) == text
        dec.close()


def test_tlg_toy_graphs_match_jax(tmp_path):
    """tests/test_fst_runtime.py's toy graphs: best path, n-best,
    partials between steps and the hotword bias that flips a decision,
    the port's decoder against JAX's."""
    import math

    lp = math.log
    for mod, name in ((fst_io, "p"), (jfst_io, "j")):
        b = mod.FstBuilder()
        e1 = b.add_string(b.start, [1, 2], [1], w=0.1)
        b.set_final(e1)
        e2 = b.add_string(b.start, [3], [2], w=0.3)
        b.set_final(e2)
        b.add_arc(e1, 0, 0, 0.0, b.start)
        b.add_arc(e2, 0, 0, 0.0, b.start)
        b.write(str(tmp_path / f"{name}.fst"))
    steps = [np.array(r, np.float32) for r in (
        [-99, lp(0.8), lp(0.1), lp(0.1)], [-99, lp(0.1), lp(0.8), lp(0.1)],
        [-99, lp(0.05), lp(0.05), lp(0.9)])]
    decs = []
    for nb, name in ((tnb, "p"), (jnb, "j")):
        d = nb.NativeTlgFstDecoder(nb.NativeFst(str(tmp_path / f"{name}.fst")),
                                   beam=10.0)
        d.start_utterance()
        parts = [d.partial()]
        for s in steps:
            d.step(s)
            parts.append(d.partial())
        decs.append((parts, d.nbest(2)))
    assert decs[0] == decs[1]
    assert decs[0][0][-1] == [1, 2] and decs[0][1][0][0] == [1, 2]
    # the bias flips an even choice
    for mod, name in ((fst_io, "p"), (jfst_io, "j")):
        b = mod.FstBuilder()
        b.set_final(b.add_string(b.start, [1], [1]))
        b.set_final(b.add_string(b.start, [2], [2]))
        b.write(str(tmp_path / f"bias_{name}.fst"))
    even = np.array([-99, lp(0.45), lp(0.55)], np.float32)
    out = []
    for nb, name in ((tnb, "p"), (jnb, "j")):
        fst = nb.NativeFst(str(tmp_path / f"bias_{name}.fst"))
        for bias in (None, nb.NativeAcBias([[1]], [3.0])):
            d = nb.NativeTlgFstDecoder(fst, bias=bias)
            d.start_utterance()
            d.step(even)
            out.append(d.nbest(1)[0][0])
    assert out == [[2], [1], [2], [1]]


def test_tlg_agrees_with_the_lm_decoder(tmp_path):
    """test_fst_runtime.py:274 on the port: on unambiguous rows the TLG
    decoder over build_tlg of an LM gives the LmDecoder's text, and an
    ambiguous word gives both hypotheses, best first."""
    word_sents = [["你好", "世界"], ["你好", "朋友"], ["世界", "很大"]] * 3
    lm = ngram.NgramLM.train(word_sents, order=2)
    words = sorted({w for s in word_sents for w in s})
    gdir = str(tmp_path / "graph")
    build_tlg.build_tlg(lm, {w: list(w) for w in words}, gdir)
    chars = sorted({c for w in words for c in w})
    token2id = {c: i + 4 for i, c in enumerate(chars)}
    token2id.update({"<blank>": 0, "<s>": 1, "</s>": 2, "<unk>": 3})
    id2tok = {i: t for t, i in token2id.items()}

    def rows_for(text):
        rows = np.full((len(text), len(token2id)), np.log(1e-4), np.float32)
        for i, ch in enumerate(text):
            rows[i, token2id[ch]] = np.log(0.99)
        return rows

    tlg = TlgDecoder(gdir, token2id, lm_weight=0.5)
    ref = LmDecoder(lm, Lexicon.from_words(words), lm_weight=0.5)
    nat = tnb.NativeLmDecoder(lm, Lexicon.from_words(words), token2id,
                              lm_weight=0.5)
    for text in ("你好世界", "你好朋友", "世界很大"):
        tlg.start_utterance()
        got = tlg.decode(rows_for(text))
        assert got == text == ref.decode(rows_for(text), id2tok.get) \
            == nat.decode(rows_for(text), id2tok.get)
    rows = rows_for("你好世界")
    rows[2, token2id["朋"]] = rows[3, token2id["友"]] = np.log(0.5)
    rows[2, token2id["世"]] = rows[3, token2id["界"]] = np.log(0.45)
    tlg.start_utterance()
    nb = tlg.decode_nbest(rows, 3)
    assert {"你好朋友", "你好世界"} <= {t for t, _ in nb}
    assert nb[0][1] <= nb[1][1]


# -- FST ITN -----------------------------------------------------------------

def _bytes(s):
    return list(s.encode("utf-8"))


def _loop_add(b, inp, out, w=0.0):
    end = b.add_string(b.start, _bytes(inp), _bytes(out), w)
    b.add_arc(end, 0, 0, 0.0, b.start)


def toy_itn_grammars(out_dir, mod=fst_io):
    """test_fst_runtime.py's multi-rule grammar pair (money, date, time
    and character passthrough; the tagger's fields out of canonical
    order), as zh_itn_tagger.fst and zh_itn_verbalizer.fst in out_dir."""
    passthrough = "今天上午我花了和在见"
    tagger = mod.FstBuilder()
    tagger.set_final(tagger.start)
    for ch in passthrough:
        _loop_add(tagger, ch, f'char {{ value: "{ch}" }} ', w=1.0)
    _loop_add(tagger, "三块五毛钱", 'money { value: "3.5" currency: "元" } ')
    _loop_add(tagger, "三月五号", 'date { day: "5" month: "3" } ')
    _loop_add(tagger, "八点半", 'time { minute: "30" hour: "8" } ')
    verb = mod.FstBuilder()
    verb.set_final(verb.start)
    for byte in _bytes(" "):
        verb.add_arc(verb.start, byte, 0, 0.0, verb.start)
    for ch in passthrough:
        _loop_add(verb, f'char {{ value: "{ch}" }}', ch)
    _loop_add(verb, 'money { currency: "元" value: "3.5" }', "3.5元")
    _loop_add(verb, 'date { month: "3" day: "5" }', "3月5日")
    _loop_add(verb, 'time { hour: "8" minute: "30" }', "8:30")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    tagger.write(str(Path(out_dir) / "zh_itn_tagger.fst"))
    verb.write(str(Path(out_dir) / "zh_itn_verbalizer.fst"))
    return out_dir


_ITN_INPUTS = ["三块五毛钱", "今天三月五号八点半我花了三块五毛钱", "今天上午",
               "你好", "", "三月五号见", "八点半和三块五毛钱在"]


def test_fst_itn_matches_jax(tmp_path):
    """FstITN over the toy grammars: JAX's output on every input, the
    rewrites applied, untagged text unchanged; two library calls a
    normalize that the tagger accepts."""
    toy_itn_grammars(tmp_path)
    args = (str(tmp_path / "zh_itn_tagger.fst"),
            str(tmp_path / "zh_itn_verbalizer.fst"))
    itn, jfst = titn.FstITN(*args), jitn.FstITN(*args)
    tnb.reset_call_counts()
    for text in _ITN_INPUTS:
        assert itn.normalize(text) == jfst.normalize(text), text
    assert tnb.call_counts()["fst_transduce"] == 2 * (len(_ITN_INPUTS) - 2) + 1
    assert itn.normalize(_ITN_INPUTS[1]) == "今天3月5日8:30我花了3.5元"
    assert itn.normalize("你好") == "你好"
    assert itn.orders is titn.ITN_ORDERS
    tn = titn.FstITN(*args, kind="tn")
    assert tn.orders is titn.TN_ORDERS


@pytest.mark.parametrize("orders", ["itn", "tn"])
def test_reorder_tagged_tokens_matches_jax(orders):
    o = (titn.ITN_ORDERS, jitn.ITN_ORDERS) if orders == "itn" else (
        titn.TN_ORDERS, jitn.TN_ORDERS)
    assert o[0] == o[1]
    for tagged in ['time { minute: "三十" hour: "八" } cardinal { value: "五" }',
                   'money { value: "3.5" currency: "元" }',
                   'fraction { denominator: "4" numerator: "3" sign: "-" }',
                   'measure { value: "5" denominator: "米" numerator: "千" }',
                   'date { day: "5" year: "2024" month: "3" } char { value: '
                   '"\\"" }', 'time {noon: "下午" second: "1"}', "", "  "]:
        assert titn.reorder_tagged_tokens(tagged, o[0]) == \
            jitn.reorder_tagged_tokens(tagged, o[1])


# -- refusals ----------------------------------------------------------------

def test_graph_and_grammar_refusals(tmp_path):
    """A graph dir without TLG.fst, a TLG.fst or ITN grammar that cannot
    be read, an LM order the library does not take, and a graph or
    automaton closed under a decoder each raise."""
    (tmp_path / "g").mkdir()
    (tmp_path / "g" / "words.txt").write_text("<eps> 0\n")
    (tmp_path / "g" / "tokens.txt").write_text("<eps> 0\n")
    with pytest.raises(FileNotFoundError, match="TLG.fst"):
        TlgGraph(str(tmp_path / "g"), VOCAB.token2id)
    (tmp_path / "g" / "TLG.fst").write_bytes(b"not an fst")
    with pytest.raises(ValueError, match="cannot read"):
        TlgDecoder(str(tmp_path / "g"), VOCAB.token2id)
    with pytest.raises(ValueError, match="cannot read"):
        titn.FstITN(str(tmp_path / "g" / "TLG.fst"),
                    str(tmp_path / "g" / "TLG.fst"))
    lm = ngram.NgramLM.train(lm_corpus(UNITS, 1), order=9)
    with pytest.raises(ValueError, match="order 9"):
        tnb.NativeLmDecoder(lm, Lexicon(), VOCAB.token2id)
    lm2, gdir = _graphs(tmp_path, 3)
    graph = TlgGraph(gdir, VOCAB.token2id)
    dec = TlgDecoder(graph, VOCAB.token2id,
                     hotwords={sorted(_word_units(lm2))[0]: 5.0})
    with pytest.raises(RuntimeError, match="in use"):
        graph.fst.close()
    with pytest.raises(RuntimeError, match="in use"):
        dec._bias.close()
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.start_utterance()
    graph.fst.close()
    with pytest.raises(RuntimeError, match="closed"):
        TlgDecoder(graph, VOCAB.token2id)


_SCANNED = ["asr2pass_tpu_torch/decode/ngram.py",
            "asr2pass_tpu_torch/decode/lm_decoder.py",
            "asr2pass_tpu_torch/decode/fst_io.py",
            "asr2pass_tpu_torch/decode/tlg.py",
            "asr2pass_tpu_torch/decode/context_graph.py",
            "asr2pass_tpu_torch/tools/build_lm.py",
            "asr2pass_tpu_torch/tools/build_tlg.py"]


def _no_fallback(tree, where):
    for node in ast.walk(tree):
        assert not isinstance(node, ast.Try), (where, node.lineno)
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Constant):
            assert node.value.value is not None, (where, node.lineno)


@pytest.mark.parametrize("path", _SCANNED)
def test_no_fallback_on_the_lm_path(path):
    """No try/except and no `return None` in the LM, TLG and FST
    modules: a failure raises to the caller."""
    _no_fallback(ast.parse((REPO / path).read_text()), path)


def test_no_fallback_in_fst_itn():
    """The same scan over text/itn.py's FST ITN (FstITN and
    reorder_tagged_tokens). The rule engine's number parsers return None
    for "not a number here", a result of the parse, and are not part of
    this path."""
    tree = ast.parse((REPO / "asr2pass_tpu_torch/text/itn.py").read_text())
    nodes = [n for n in tree.body
             if getattr(n, "name", "") in ("FstITN", "reorder_tagged_tokens")]
    assert len(nodes) == 2
    for n in nodes:
        _no_fallback(n, n.name)
