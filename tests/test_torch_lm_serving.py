"""LM and TLG rescoring through the port's recognizers and ServerModels,
against the JAX package's on the CPU (the engine and the server:
tests/test_torch_lm_engine.py).

Weights come from the JAX `init` (paraformer_tiny, sensevoice_tiny,
VadConfig(), punc_tiny) and reach the port through `params_from_jax`;
the LM is trained on a corpus drawn from a seed over the test
vocabulary's units and its graphs built by the port's build_tlg
(tests/torch_parity.lm_test_dirs). Texts and timestamps must be equal;
the LM rows copied to the host are counted to the byte.
"""

import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.decode.lm_decoder import Lexicon as JLexicon
from asr2pass_tpu.decode.tlg import TlgDecoder as JTlgDecoder
from asr2pass_tpu.native import bindings as jnb
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.runtime.offline_asr import ParaformerOffline as JOffline
from asr2pass_tpu.runtime.sensevoice_asr import SenseVoiceOffline as JSvs
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.decode import tlg as ttlg
from asr2pass_tpu_torch.decode.lm_decoder import Lexicon, LmDecoder
from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
from asr2pass_tpu_torch.server.engine import ServerModels
from asr2pass_tpu_torch.server.run_server import build_models, parser
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import (jax_params, lm_test_dirs, lm_trees, speechy,
                          svs_tree, tiny_cfgs)

VOCAB = make_test_vocab(64)
LM_WEIGHT = 1.5         # strong enough that the LM changes tiny models' texts


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_dirs(tmp_path_factory):
    return lm_test_dirs(tmp_path_factory.mktemp("lm"))


def _decoders(kind, d, hotwords=None):
    """(port decoder, JAX decoder) of one kind over lm_dirs' LM."""
    lex = Lexicon.from_file(d["arpa"] + "/lexicon.txt")
    jlex = JLexicon.from_file(d["arpa"] + "/lexicon.txt")
    if kind == "native":
        return (tnb.NativeLmDecoder(d["lm"], lex, VOCAB.token2id,
                                    lm_weight=LM_WEIGHT, hotwords=hotwords),
                jnb.NativeLmDecoder(d["jlm"], jlex, VOCAB.token2id,
                                    lm_weight=LM_WEIGHT, hotwords=hotwords))
    if kind == "python":
        from asr2pass_tpu.decode.lm_decoder import LmDecoder as JLmDecoder

        return (LmDecoder(d["lm"], lex, lm_weight=LM_WEIGHT),
                JLmDecoder(d["jlm"], jlex, lm_weight=LM_WEIGHT))
    g = d["ctc"] if kind == "ctc" else d["tlg"]
    return (TlgDecoder(g, VOCAB.token2id, lm_weight=LM_WEIGHT,
                       hotwords=hotwords),
            JTlgDecoder(g, VOCAB.token2id, lm_weight=LM_WEIGHT,
                        hotwords=hotwords))


# -- the recognizers ---------------------------------------------------------

@pytest.fixture(scope="module")
def paraformers():
    out = {}
    rng = np.random.default_rng(3)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    for ts in (False, True):
        jcfg, tcfg = tiny_cfgs(timestamp=ts)
        tree = jax_params(jcfg, 0)
        out[ts] = (JOffline(tree, jcfg, VOCAB, cmvn=cmvn),
                   ParaformerOffline(params_from_jax(tree), tcfg,
                                     TVocab(VOCAB.tokens), cmvn=cmvn,
                                     device="cpu"))
    return out


@pytest.mark.parametrize("kind,timestamp", [("native", True),
                                            ("python", False),
                                            ("tlg", True)])
def test_recognize_batch_with_lm_matches_jax(paraformers, lm_dirs, kind,
                                             timestamp):
    """A mixed batch (two buckets): items with the recognizer's LM
    decoder, with their own, and without; JAX's texts and timestamps.
    Only the LM items' token rows reach the host, gathered to the
    graph's labels for a TLG decoder."""
    jasr, tasr = paraformers[timestamp]
    segs = [speechy(s, 40 + i) for i, s in enumerate((1.5, 5.0, 2.5, 3.5))]
    base, jbase = _decoders(kind, lm_dirs)
    own, jown = _decoders(kind, lm_dirs)
    greedy = tasr.recognize_batch(segs)
    jasr.lm_decoder, tasr.lm_decoder = jbase, base
    try:
        tasr.lm_bytes_copied = 0
        want = jasr.recognize_batch(segs, lm_decoders=[None, jown, None,
                                                       None])
        got = tasr.recognize_batch(segs, lm_decoders=[None, own, None, None])
        tasr.lm_decoder = None
        mixed = tasr.recognize_batch(segs, lm_decoders=[own, None, None,
                                                        None])
    finally:
        jasr.lm_decoder = tasr.lm_decoder = None
    assert got == want
    assert mixed[1:] == greedy[1:] and mixed[0] == got[0]
    assert any(g[0] != r[0] for g, r in zip(got, greedy))
    if timestamp:
        assert all(ts for _, ts in got)
    # all four items rescored, then item 0 alone: [count, width] fp32
    width = (len(TlgGraph(lm_dirs["tlg"], VOCAB.token2id).gather)
             if kind == "tlg" else 64)
    n_tok = _token_counts(tasr, segs)
    assert tasr.lm_bytes_copied == (sum(n_tok) + n_tok[0]) * width * 4


def _token_counts(asr, segs):
    """token_num of each segment, as recognize_batch's forwards see
    them."""
    pending, handles = asr.dispatch_batch(segs)
    out = [0] * len(segs)
    for rec in pending["records"]:
        counts = handles[rec["off"] + 1]
        for k, i in enumerate(rec["idxs"]):
            out[i] = int(counts[k])
    return out


@pytest.fixture(scope="module")
def sensevoices():
    tree = svs_tree(0, seed=5)
    cfg, tcfg = jconfig.sensevoice_tiny(), tconfig.sensevoice_tiny()
    return (JSvs(tree, cfg, VOCAB, lang="zh"),
            SenseVoiceOffline(params_from_jax(tree), tcfg,
                              TVocab(VOCAB.tokens), lang="zh", device="cpu"))


def test_sensevoice_tlg_matches_jax(sensevoices, lm_dirs):
    """tests/test_sensevoice_ctc.py:330-370 on the port: a CTC graph
    constrains the LM items to its words; items without an LM equal a
    batch with no LM; every text equals JAX's; only the LM items' frames
    reach the host, as [T, labels] rows."""
    jrec, trec = sensevoices
    waves = [speechy(s, 60 + i) for i, s in enumerate((1.0, 1.6, 1.2))]
    base = trec.recognize_batch(waves)
    dec, jdec = _decoders("ctc", lm_dirs)
    dec2, jdec2 = _decoders("ctc", lm_dirs)
    trec.lm_bytes_copied = 0
    got = trec.recognize_batch(waves, lm_decoders=[dec, None, dec2])
    want = jrec.recognize_batch(waves, lm_decoders=[jdec, None, jdec2])
    assert got == want
    assert got[1] == base[1]
    allowed = set("".join(lm_dirs["words"]))
    assert all(set(t) <= allowed for t, _ in (got[0], got[2]))
    assert any(t for t, _ in (got[0], got[2]))
    g = len(dec.graph.gather)
    assert trec.lm_bytes_copied == (_svs_frames(trec, waves[0])
                                    + _svs_frames(trec, waves[2])) * g * 4
    # the recognizer's own decoder, from the constructor
    rec = SenseVoiceOffline(trec.model, trec.cfg, trec.vocab, lang="zh",
                            lm_decoder=dec, device="cpu")
    assert rec.recognize(waves[0]) == got[0]


def _svs_frames(rec, wave):
    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.frontend.lfr import lfr_len

    fcfg = rec.cfg.frontend
    return lfr_len(num_frames(len(wave), fcfg), fcfg.lfr_m, fcfg.lfr_n)


def test_sensevoice_refuses_what_cannot_decode_frames(sensevoices, lm_dirs):
    """A per-token graph (no blank unit) and a trie LM decoder are each
    refused with ValueError, in the constructor and per item."""
    _, trec = sensevoices
    wave = speechy(1.0, 1)
    for kind in ("tlg", "native"):
        dec, _ = _decoders(kind, lm_dirs)
        with pytest.raises(ValueError, match="CTC"):
            trec.recognize_batch([wave], lm_decoders=[dec])
        with pytest.raises(ValueError, match="CTC"):
            SenseVoiceOffline(trec.model, trec.cfg, trec.vocab,
                              lm_decoder=dec, device="cpu")


# -- ServerModels ----------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    return lm_trees()


def _models(trees, svs=False, **kw):
    return ServerModels(
        asr_params=params_from_jax(trees["asr"]), asr_cfg=trees["tcfg"],
        vocab=TVocab(VOCAB.tokens), vad_params=params_from_jax(trees["vad"]),
        vad_cfg=tconfig.VadConfig(),
        svs_params=params_from_jax(trees["svs"]) if svs else None,
        svs_cfg=tconfig.sensevoice_tiny() if svs else None,
        svs_vocab=TVocab(VOCAB.tokens) if svs else None, device="cpu", **kw)


def test_server_models_lm_wiring(trees, lm_dirs, monkeypatch):
    """lm + lexicon: one native base decoder shared by connections
    without hotwords, a clone per hotworded one (freed by
    release_lm_decoder, the base never), the Python decoder only with
    lm_native=False; a TLG dir loads once per vocabulary role and gives
    each connection its own TlgDecoder; with an LM the offline
    recognizer is built per request (test_server.py:282's plumbing
    case: its pass 2 has the decoder)."""
    lex = Lexicon.from_file(lm_dirs["arpa"] + "/lexicon.txt")
    m = _models(trees, lm=lm_dirs["lm"], lexicon=lex)
    base = m._make_lm_decoder()
    hot = {lm_dirs["words"][0]: 8}
    clone = m._make_lm_decoder(hot)
    assert isinstance(base, tnb.NativeLmDecoder) and base is \
        m._make_lm_decoder()
    assert clone is not base and clone.hotwords == hot
    rec = m.create_offline_recognizer()
    assert rec.asr.lm_decoder is base
    assert m.offline_recognizer_cached() is not m.offline_recognizer_cached()
    m.release_lm_decoder(base)
    m.release_lm_decoder(clone)
    rows = np.zeros((2, 64), np.float32)
    assert isinstance(base.decode(rows, VOCAB.id2token), str)
    with pytest.raises(RuntimeError, match="closed"):
        clone.decode(rows, VOCAB.id2token)
    py = _models(trees, lm=lm_dirs["lm"], lexicon=lex, lm_native=False)
    assert type(py._make_lm_decoder(hot)) is LmDecoder
    loads = []
    real = ttlg.NativeFst
    monkeypatch.setattr(ttlg, "NativeFst",
                        lambda p: loads.append(p) or real(p))
    t = _models(trees, svs=True, tlg_dir=lm_dirs["ctc"])
    decs = [t._make_lm_decoder(hot if i % 2 else None) for i in range(4)]
    decs += [t._svs_lm_decoder(hot) for _ in range(2)]
    assert len(loads) == 2            # one graph per role, at start
    assert all(d.graph is decs[0].graph for d in decs[:4])
    assert decs[4].graph is decs[5].graph is not decs[0].graph
    assert len({id(d) for d in decs}) == 6
    svs_rec = t.create_offline_recognizer(use_svs=True)
    assert isinstance(svs_rec.asr.lm_decoder, TlgDecoder)
    assert t.create_offline_recognizer().asr.lm_decoder is not None


def test_svs_role_refuses_a_per_token_graph(trees, lm_dirs, tmp_path):
    """ADVICE's server/engine.py:147 finding, decided: the SenseVoice
    role given a graph without the CTC topology raises when the models
    are built, through ServerModels and through build_models; the same
    graph serves the Paraformer role."""
    with pytest.raises(ValueError, match="ctc-blank"):
        _models(trees, svs=True, tlg_dir=lm_dirs["tlg"])
    assert _models(trees, tlg_dir=lm_dirs["tlg"])._make_lm_decoder()
    jzoo.save_offline_bundle(str(tmp_path / "asr"), trees["asr"],
                             trees["jcfg"], VOCAB.tokens)
    cmvn = (np.full(560, -10.0, np.float32), np.full(560, 0.3, np.float32))
    jzoo.save_svs_bundle(str(tmp_path / "svs"), trees["svs"],
                         jconfig.sensevoice_tiny(), VOCAB.tokens, cmvn)
    argv = ["--model-dir", str(tmp_path / "asr"), "--svs-dir",
            str(tmp_path / "svs"), "--device", "cpu", "--lm-dir"]
    with pytest.raises(ValueError, match="ctc-blank"):
        build_models(parser().parse_args(argv + [lm_dirs["tlg"]]))
    m = build_models(parser().parse_args(argv + [lm_dirs["ctc"]]))
    assert m.tlg_dir == lm_dirs["ctc"]
    with pytest.raises(FileNotFoundError, match="lm.arpa"):
        build_models(parser().parse_args(argv + [str(tmp_path)]))
