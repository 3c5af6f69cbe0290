"""The port's SenseVoice pass 2 against the JAX package's on the CPU: the
model forward (with and without the tp stack), greedy_ids, the device
first prune, the CTC decoders, the recognizer with per-item options, and
SenseVoice dirs across the two packages.

Weights come from the JAX `init` (sensevoice_tiny: d=64, 2 blocks, vocab
64; the tp stack as a converted checkpoint carries it, 2 blocks here)
and reach the port through `params_from_jax`; inputs are made with
numpy from a seed. Tolerances: logits 1e-5 abs (fp32 at d=64, summed in
another order); first-prune log-probs 1e-5; ids, counts, meta ids,
n-best lists and texts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.decode import ctc as jctc
from asr2pass_tpu.decode.context_graph import ContextGraph as JContextGraph
from asr2pass_tpu.models import sensevoice as jsv
from asr2pass_tpu.parallel import ctc_shard as jshard
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.runtime import sensevoice_asr as jsva
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.decode import ctc as tctc
from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.models import sensevoice as tsv
from asr2pass_tpu_torch.parallel import ctc_shard as tshard
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from asr2pass_tpu_torch.runtime import sensevoice_asr as tsva
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import svs_tree

LOGITS_ATOL = 1e-5
LOGP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wave(seed, seconds=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(
        np.float32)


@pytest.fixture(scope="module", params=[0, 2], ids=["no_tp", "tp2"])
def pair(request):
    """(JAX params, port model, tp_blocks)."""
    tree = svs_tree(request.param)
    model = tsv.from_state_dict(params_from_jax(tree),
                                tconfig.sensevoice_tiny(), "cpu")
    assert (model.tp is not None) == bool(request.param)
    return tree, model, request.param


def _inputs(seed, b=3, t=24):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 560)).astype(np.float32)
    lens = np.array([t, 17, 0][:b], np.int64)
    lid = np.array([3, 4, 0][:b], np.int64)
    tn = np.array([14, 15, 14][:b], np.int64)
    return feats, lens, lid, tn


def test_forward_matches_jax(pair):
    """A padded batch with a length-0 row (its 4 meta positions valid)."""
    tree, model, _ = pair
    feats, lens, lid, tn = _inputs(1)
    want = jsv.apply(tree, jconfig.sensevoice_tiny(), jnp.asarray(feats),
                     jnp.asarray(lens), jnp.asarray(lid), jnp.asarray(tn))
    with torch.inference_mode():
        got = tsv.apply(model, tconfig.sensevoice_tiny(),
                        torch.from_numpy(feats), torch.from_numpy(lens),
                        torch.from_numpy(lid), torch.from_numpy(tn))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=LOGITS_ATOL)


def test_greedy_ids_match_jax(pair):
    """ids, counts and meta of the device greedy are JAX's exactly, on the
    model's own logits and on peaked logits with repeats and blanks."""
    tree, model, _ = pair
    feats, lens, lid, tn = _inputs(2)
    jout = jsv.apply(tree, jconfig.sensevoice_tiny(), jnp.asarray(feats),
                     jnp.asarray(lens), jnp.asarray(lid), jnp.asarray(tn))
    with torch.inference_mode():
        tout = tsv.apply(model, tconfig.sensevoice_tiny(),
                         torch.from_numpy(feats), torch.from_numpy(lens),
                         torch.from_numpy(lid), torch.from_numpy(tn))
    seq = [0, 1, 1, 0, 2, 2, 2, 3, 0, 3]
    peaked = np.full((2, 4 + len(seq), 6), -10.0, np.float32)
    peaked[:, :4, 5] = 10.0
    for j, s in enumerate(seq):
        peaked[:, 4 + j, s] = 10.0
    plens = np.array([4 + len(seq), 9], np.int64)
    cases = [(tout, jout),
             (tsv.SenseVoiceOutput(torch.from_numpy(peaked),
                                   torch.from_numpy(plens)),
              jsv.SenseVoiceOutput(jnp.asarray(peaked), jnp.asarray(plens)))]
    for t_out, j_out in cases:
        got = tsv.greedy_ids(t_out, blank_id=0)
        want = jsv.greedy_ids(j_out, blank_id=0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _logits(seed, b=2, t=9, v=40):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, v)).astype(np.float32) * 2.0


def _same_sets(t_ids, t_lp, j_ids, j_lp):
    """Each frame's candidates as sets of ids, log-probs per id within
    LOGP_ATOL (top-k orders ties its own way)."""
    t_ids, j_ids = np.asarray(t_ids), np.asarray(j_ids)
    t_lp, j_lp = np.asarray(t_lp), np.asarray(j_lp)
    assert t_ids.shape == j_ids.shape
    for idx in np.ndindex(*t_ids.shape[:-1]):
        assert set(t_ids[idx].tolist()) == set(j_ids[idx].tolist())
        order_t, order_j = np.argsort(t_ids[idx]), np.argsort(j_ids[idx])
        np.testing.assert_allclose(t_lp[idx][order_t], j_lp[idx][order_j],
                                   rtol=0, atol=LOGP_ATOL)


@pytest.mark.parametrize("k", [8, 64])
def test_first_prune_matches_jax(k):
    x = _logits(3)
    t_ids, t_lp = tshard.ctc_first_prune(torch.from_numpy(x), k=k)
    j_ids, j_lp = jshard.ctc_first_prune(jnp.asarray(x), k=k)
    assert t_ids.shape[-1] == min(k, x.shape[-1])
    _same_sets(t_ids, t_lp, j_ids, j_lp)


def test_first_prune_gather_matches_jax():
    x = _logits(4)
    cols = [3, 17, 25, 38]
    t_ids, t_lp, t_hw = tshard.ctc_first_prune_gather(torch.from_numpy(x),
                                                      cols, k=8)
    j_ids, j_lp, j_hw = jshard.ctc_first_prune_gather(jnp.asarray(x), cols,
                                                      k=8)
    _same_sets(t_ids, t_lp, j_ids, j_lp)
    np.testing.assert_allclose(t_hw.numpy(), np.asarray(j_hw), rtol=0,
                               atol=LOGP_ATOL)
    np.testing.assert_allclose(
        tshard.ctc_gather_logp(torch.from_numpy(x), cols).numpy(),
        np.asarray(jshard.ctc_gather_logp(jnp.asarray(x),
                                          jnp.asarray(cols, jnp.int32))),
        rtol=0, atol=LOGP_ATOL)


def test_merge_candidates_matches_jax():
    rng = np.random.default_rng(5)
    cid = rng.integers(0, 40, (7, 8)).astype(np.int32)
    clp = rng.standard_normal((7, 8)).astype(np.float32)
    hw_ids = [int(cid[0, 0]), 39, 41]
    hw_lp = rng.standard_normal((7, 4)).astype(np.float32)
    for got, want in zip(tsva._merge_candidates(cid, clp, hw_ids, hw_lp),
                         jsva._merge_candidates(cid, clp, hw_ids, hw_lp)):
        np.testing.assert_array_equal(got, want)


def _logp_rows(seed, t=14, v=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, v)).astype(np.float32) * 3.0
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _graphs(vocab):
    t = vocab.id2token
    words = {t(4) + t(5): None, t(6) + t(7) + t(8): 2.0, t(9): 4.0}
    return ContextGraph(3.0).build(words), JContextGraph(3.0).build(words)


@pytest.mark.parametrize("with_context", [False, True])
def test_prefix_beam_matches_jax_spec(with_context):
    """Full-row and pruned prefix beams, n-best ids, scores and times,
    the port's Python spec (use_native=False, the plain version) against
    JAX's (use_native=False): equal."""
    vocab = make_test_vocab(12)
    tg, jg = _graphs(vocab) if with_context else (None, None)
    kw = dict(id_to_token=vocab.id2token)
    for seed in range(3):
        logp = _logp_rows(10 + seed)
        got = tctc.ctc_prefix_beam_search(logp, len(logp), beam=5,
                                          first_beam=6, context=tg, **kw)
        want = jctc.ctc_prefix_beam_search(logp, len(logp), beam=5,
                                           first_beam=6, context=jg, **kw)
        assert got == want
        ids = np.argsort(-logp, axis=-1)[:, :6].astype(np.int32)
        lp = np.take_along_axis(logp, ids, -1)
        got = tctc.ctc_prefix_beam_search_pruned(
            ids, lp, len(logp), beam=5, context=tg, use_native=False, **kw)
        want = jctc.ctc_prefix_beam_search_pruned(
            ids, lp, len(logp), beam=5, context=jg, use_native=False, **kw)
        assert got == want and got


@pytest.mark.parametrize("with_context", [False, True])
def test_prefix_beam_native_matches_jax_spec(with_context):
    """The pruned beam on the port's default, the native library, against
    JAX's Python spec: n-best ids and times equal, scores within 1e-4
    (the C++ beam sums in double and returns fp32 scores)."""
    vocab = make_test_vocab(12)
    tg, jg = _graphs(vocab) if with_context else (None, None)
    for seed in range(3):
        logp = _logp_rows(10 + seed)
        ids = np.argsort(-logp, axis=-1)[:, :6].astype(np.int32)
        lp = np.take_along_axis(logp, ids, -1)
        got = tctc.ctc_prefix_beam_search_pruned(
            ids, lp, len(logp), beam=5, context=tg,
            token2id=vocab.token2id)
        want = jctc.ctc_prefix_beam_search_pruned(
            ids, lp, len(logp), beam=5, context=jg,
            id_to_token=vocab.id2token, use_native=False)
        assert got and [h[0] for h in got] == [h[0] for h in want]
        assert [h[2] for h in got] == [h[2] for h in want]
        np.testing.assert_allclose([h[1] for h in got],
                                   [h[1] for h in want], atol=1e-4)


def test_greedy_matches_jax():
    logits = _logp_rows(20, t=16)
    for skip in (0, 4):
        assert (tctc.ctc_greedy(logits, 14, skip_first=skip)
                == jctc.ctc_greedy(logits, 14, skip_first=skip))


def test_context_unit_ids_match_jax():
    vocab = make_test_vocab(12)
    tg, jg = _graphs(vocab)
    assert (tsva.context_unit_ids(tg, vocab.token2id)
            == jsva.context_unit_ids(jg, vocab.token2id))
    assert tsva.context_unit_ids(None, vocab.token2id) == []


@pytest.fixture(scope="module")
def recognizers():
    """(JAX SenseVoiceOffline, port SenseVoiceOffline) factories over one
    set of weights (sensevoice_tiny with a 2-block tp stack) and cmvn."""
    tree = svs_tree(2, seed=1)
    vocab = make_test_vocab(64)
    rng = np.random.default_rng(6)
    cmvn = (rng.uniform(-2, 2, 560).astype(np.float32),
            rng.uniform(0.5, 1.5, 560).astype(np.float32))
    model = tsv.from_state_dict(params_from_jax(tree),
                                tconfig.sensevoice_tiny(), "cpu")

    def make(**kw):
        jctx, tctx = kw.pop("jctx", None), kw.pop("tctx", None)
        j = jsva.SenseVoiceOffline(tree, jconfig.sensevoice_tiny(), vocab,
                                   cmvn=cmvn, context=jctx, **kw)
        t = tsva.SenseVoiceOffline(model, tconfig.sensevoice_tiny(),
                                   TVocab(vocab.tokens), cmvn=cmvn,
                                   context=tctx, device="cpu", **kw)
        return j, t

    return make, vocab


@pytest.mark.parametrize("beam", [0, 4])
def test_recognizer_per_item_options_match_jax(recognizers, beam):
    """Per-item langs, itn_flags and contexts (greedy and beam items in
    one batch, two length buckets): equal texts and meta ids."""
    make, vocab = recognizers
    j, t = make(lang="zh", beam=beam)
    waves = [_wave(30 + i, s) for i, s in enumerate((1.0, 1.3, 4.5, 0.8))]
    hot = {vocab.id2token(7) + vocab.id2token(8): 40.0}
    kw_j = dict(langs=["en", None, "ja", "auto"],
                itn_flags=[False, None, True, None],
                contexts=[JContextGraph().build(hot), None, None,
                          JContextGraph().build(hot)])
    kw_t = dict(kw_j, contexts=[ContextGraph().build(hot), None, None,
                                ContextGraph().build(hot)])
    want = j.recognize_batch(waves, with_meta=True, **kw_j)
    got = t.recognize_batch(waves, with_meta=True, **kw_t)
    assert got == want
    assert len({m[0] for _, _, m in got}) >= 1
    assert t.recognize(waves[0]) == j.recognize(waves[0])


def test_recognizer_context_biases_like_jax(recognizers):
    """A recognizer-level context graph with a strong boost changes the
    text, the same way in both packages."""
    make, vocab = recognizers
    hot = {vocab.id2token(7) + vocab.id2token(8): 90.0}
    base_j, _ = make(lang="zh")
    j, t = make(lang="zh", jctx=JContextGraph().build(hot),
                tctx=ContextGraph().build(hot))
    wave = _wave(40, 1.0)
    assert t.recognize(wave) == j.recognize(wave)
    assert t.recognize(wave) != base_j.recognize(wave)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_svs_dirs_cross_load(tmp_path, writer):
    """A SenseVoice dir written by either package loads in the other:
    same config, weights and recognizer output."""
    tree = svs_tree(2, seed=2)
    vocab = make_test_vocab(64)
    cmvn = (np.full(560, -1.0, np.float32), np.full(560, 0.8, np.float32))
    path = str(tmp_path / "svs")
    if writer == "jax":
        jzoo.save_svs_bundle(path, tree, jconfig.sensevoice_tiny(),
                             vocab.tokens, cmvn)
    else:
        tzoo.save_svs_bundle(path, params_from_jax(tree),
                             tconfig.sensevoice_tiny(), vocab.tokens, cmvn)
    jb, tb = jzoo.load_svs_bundle(path), tzoo.load_svs_bundle(path)
    assert tb.cfg == tconfig.sensevoice_tiny()
    assert jb.cfg == jconfig.sensevoice_tiny()
    assert set(tb.params) == set(params_from_jax(tree))
    for k, v in params_from_jax(jax.tree.map(np.asarray, jb.params)).items():
        np.testing.assert_array_equal(tb.params[k].numpy(), v.numpy())
    wave = _wave(41, 1.2)
    want = jsva.SenseVoiceOffline(jb.params, jb.cfg, jb.vocab,
                                  cmvn=jb.cmvn).recognize(wave)
    got = tsva.SenseVoiceOffline(tb.params, tb.cfg, tb.vocab, cmvn=tb.cmvn,
                                 device="cpu").recognize(wave)
    assert got == want
