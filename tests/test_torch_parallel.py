"""The port's tensor parallelism against the JAX package on the CPU: the
sharding rules against JAX's, the TP Paraformer forward at tp 2 and 4
(heads = tp) with hotwords and timestamps, the dp x tp recognizer, tp 4
over 2 heads (the attention whole), int8 trees at tp 2 (every unit
whole), tp with sp, SenseVoice at tp 2 and 4 with the vocab-sharded CTC
prune, and the two refusals. The port runs in 4 gloo ranks spawned by the module's fixtures
(tests/torch_parallel_workers.py, one spawn a fixture); JAX runs here,
unsharded and on its 8 virtual CPU devices."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.models import sensevoice as jsv
from asr2pass_tpu.parallel import ctc_shard as jctc
from asr2pass_tpu.parallel import sharding as jsharding
from asr2pass_tpu.runtime.offline_asr import ParaformerOffline as JOffline
from asr2pass_tpu.runtime.sensevoice_asr import SenseVoiceOffline as JSvs
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch.parallel import sharding as tsharding
from asr2pass_tpu_torch.runtime.model_zoo import _STACKED, params_from_jax
from torch_parallel_workers import spawn
from torch_parity import speechy

WORLD = 4
# logits, alphas and peaks against JAX's and the unsharded port's: each
# within 1e-4 of the reference's range (the partial sums of the
# row-parallel layers add in another order)
RANGE_TOL = 1e-4
PRUNE_K = 16
LOGP_ATOL = 1e-5
# LFR frames (3.84 s): the 1 s segment takes the TP path, the 6 s one SP
SP_THRESHOLD = 64

# keys the JAX rules shard and the port keeps whole, and why
REPLICATED = {
    "decoder/blocks/fsmn/taps": "the decoder's FSMN runs on the whole "
                                "width, after the FFN's reduce",
    "predictor/blstm/": "the bicif BLSTM runs whole on every rank",
    "_embed": "SenseVoice's meta tables feed the replicated encoder "
              "input",
}


def _jcfg(heads, timestamp=False, hotword=False, vocab=64):
    """tests/test_parallel.py's _tp_cfg with `heads` heads (the workers'
    tp_cfg in the port)."""
    d = 32
    return jconfig.ParaformerConfig(
        encoder=jconfig.EncoderConfig(input_size=560, output_size=d,
                                      num_blocks=2, attention_heads=heads,
                                      linear_units=4 * d),
        decoder=jconfig.DecoderConfig(num_blocks=2, attention_heads=heads,
                                      linear_units=4 * d),
        predictor=jconfig.PredictorConfig(idim=d, use_timestamp=timestamp),
        vocab_size=vocab, use_hotword=hotword)


def _svs_jcfg(heads):
    cfg = jconfig.sensevoice_tiny()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, attention_heads=heads))


def _tree(cfg, seed, init=jparaformer.init):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def _put(inputs, name, tree):
    for k, v in params_from_jax(tree).items():
        inputs[f"w/{name}/{k}"] = v.numpy()


def _within_range(got, ref, tol=RANGE_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------

def _jax_dims(tree, mesh):
    """{JAX path: the dim sharded over "tp", or None}."""
    flat = jax.tree_util.tree_flatten_with_path(
        jsharding.param_shardings(tree, mesh))[0]
    out = {}
    for path, sh in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        spec = tuple(sh.spec)
        out[key] = spec.index("tp") if "tp" in spec else None
    return out


def _jax_key(port_key):
    """Port key -> (JAX path, offset of a stacked layer axis)."""
    path = port_key.replace(".", "/")
    for stem in _STACKED:
        if path.startswith(stem + "/"):
            rest = path[len(stem) + 1:].split("/", 1)[1]
            return f"{stem}/{rest}", 1
    return path, 0


@pytest.mark.parametrize("model", ["paraformer", "sensevoice"])
def test_param_specs_agree_with_jax_rules(model):
    """Every key the port shards is sharded on the same dim by JAX; each
    key JAX shards and the port keeps whole is one REPLICATED names."""
    if model == "paraformer":
        tree = _tree(_jcfg(2, timestamp=True, hotword=True), 0)
    else:
        tree = _tree(jconfig.sensevoice_tiny(), 0, jsv.init)
        tree["tp"] = {"rest": jax.tree.map(lambda a: a[:1],
                                           tree["encoder"]["rest"]),
                      "norm": tree["encoder"]["after_norm"]}
    jdims = _jax_dims(tree, jsharding.make_mesh(8, tp=2))
    specs = tsharding.param_specs(params_from_jax(tree))
    assert specs
    used = set()
    for key, dim in specs.items():
        jkey, off = _jax_key(key)
        jdim = jdims[jkey]
        if dim is not None:
            assert jdim == dim + off, (key, dim, jdim)
            continue
        if jdim is None:
            continue
        why = [pat for pat in REPLICATED if pat in jkey]
        assert why, f"{key}: JAX shards dim {jdim}, the port keeps it whole"
        used.update(why)
    assert any(d is not None for d in specs.values())
    want = ({"_embed"} if model == "sensevoice" else
            {"decoder/blocks/fsmn/taps", "predictor/blstm/"})
    assert used == want


# ---------------------------------------------------------------------------
# Paraformer: the forwards, the recognizer, the refusals (one spawn)
# ---------------------------------------------------------------------------

FORWARDS = [{"name": "tp2", "tp": 2, "heads": 2, "timestamp": True,
             "hotword": True},
            {"name": "tp4", "tp": 4, "heads": 4, "timestamp": False,
             "hotword": False}]


@pytest.fixture(scope="module")
def para(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs, trees = {}, {}
    for i, c in enumerate(FORWARDS):
        cfg = _jcfg(c["heads"], c["timestamp"], c["hotword"])
        trees[c["name"]] = (cfg, _tree(cfg, i))
        _put(inputs, c["name"], trees[c["name"]][1])
    rec_cfg = _jcfg(2, timestamp=True, hotword=True)
    trees["rec"] = (rec_cfg, _tree(rec_cfg, 7))
    _put(inputs, "rec", trees["rec"][1])
    inputs["feats"] = rng.standard_normal((4, 20, 560)).astype(np.float32)
    inputs["lengths"] = np.array([20, 17, 12, 20], np.int32)
    inputs["hw_emb"] = rng.standard_normal((4, 5, 32)).astype(np.float32)
    inputs["hw_mask"] = (np.arange(5)[None] < np.array([5, 3, 1, 0])[:, None]
                         ).astype(np.float32)
    segs = [speechy(s, 30 + i) for i, s in enumerate((1.0, 2.0, 1.5))]
    for i, s in enumerate(segs):
        inputs[f"seg{i}"] = s
    inputs["n_segs"] = np.array(len(segs))
    inputs["long"] = speechy(6.0, 40)
    outs = spawn("paraformer_tp", tmp_path_factory.mktemp("para"), WORLD,
                 inputs, {"forwards": FORWARDS, "sp_threshold": SP_THRESHOLD})
    return dict(outs=outs, trees=trees, inputs=inputs, segs=segs)


def _jax_forward(para, name):
    cfg, tree = para["trees"][name]
    inp = para["inputs"]
    kw = {}
    if cfg.use_hotword:
        kw = dict(hw_emb=jnp.asarray(inp["hw_emb"]),
                  hw_mask=jnp.asarray(inp["hw_mask"]))
    return jparaformer.apply(tree, cfg, jnp.asarray(inp["feats"]),
                             jnp.asarray(inp["lengths"]),
                             max_tokens=inp["feats"].shape[1] // 2 + 8, **kw)


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_tp_forward_matches_jax_and_unsharded(para, name):
    """token_num equal, logits within RANGE_TOL of their range, against
    JAX's unsharded apply and the port's unsharded forward; every rank
    holds the same output."""
    ref = _jax_forward(para, name)
    outs = para["outs"]
    want_n = np.asarray(ref.token_num)
    for o in outs:
        np.testing.assert_array_equal(o[f"{name}/tp/logits"],
                                      outs[0][f"{name}/tp/logits"])
    o = outs[0]
    np.testing.assert_array_equal(o[f"{name}/tp/token_num"], want_n)
    np.testing.assert_array_equal(o[f"{name}/whole/token_num"], want_n)
    for k, n in enumerate(want_n):
        _within_range(o[f"{name}/tp/logits"][k, :n],
                      np.asarray(ref.logits)[k, :n])
        _within_range(o[f"{name}/tp/logits"][k, :n],
                      o[f"{name}/whole/logits"][k, :n])


def test_tp_forward_timestamp_head_matches_jax(para):
    """The bicif head (replicated) under tp 2: upsampled alphas and peaks
    within RANGE_TOL of JAX's."""
    ref = _jax_forward(para, "tp2")
    o = para["outs"][0]
    _within_range(o["tp2/tp/us_alphas"], ref.us_alphas)
    _within_range(o["tp2/tp/us_cif_peak"], ref.us_cif_peak)


def test_tp_forward_hotwords_reach_the_decoder(para):
    """tp 2 ran with hotword embeddings; without them JAX's logits differ
    from what the port returned, so the sharded bias block was in the
    forward."""
    cfg, tree = para["trees"]["tp2"]
    inp = para["inputs"]
    plain = jparaformer.apply(tree, cfg, jnp.asarray(inp["feats"]),
                              jnp.asarray(inp["lengths"]),
                              max_tokens=inp["feats"].shape[1] // 2 + 8)
    n = int(plain.token_num[0])
    got = para["outs"][0]["tp2/tp/logits"][0, :n]
    assert np.abs(got - np.asarray(plain.logits)[0, :n]).max() > 1e-3


@pytest.mark.parametrize("name,tp", [("tp2", 2), ("tp4", 4)])
def test_tp_ranks_hold_their_heads(para, name, tp):
    """Each rank's fused qkv holds H/tp heads: [560, 3 * 32 / tp]."""
    for o in para["outs"]:
        assert o["json"][f"{name}/qkv_shape"] == [560, 3 * 32 // tp]


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_tp_collectives_per_forward(para, name):
    """One all-reduce per row-parallel layer (2 an encoder block, 2 a
    decoder block, the tail FFN, the hotword block when it runs), one
    all-gather per SAN-M memory and one for the vocab head."""
    hotword = name == "tp2"
    want = {"all_reduce": 2 * 2 + 2 * 2 + 1 + hotword,
            "all_gather": 2 + 1, "halo": 0, "broadcast": 0}
    assert para["outs"][0]["json"][f"{name}/collectives"] == want


def _jax_rec(para):
    cfg, tree = para["trees"]["rec"]
    return JOffline(tree, cfg, make_test_vocab(cfg.vocab_size))


def _as_result(items):
    return [(t, [list(s) for s in stamps]) for t, stamps in items]


def test_tp_recognizer_serving_parity(para):
    """ParaformerOffline at dp 2 x tp 2 (the rows split over dp): JAX's
    texts and timestamps, on every rank."""
    want = _as_result(_jax_rec(para).recognize_batch(para["segs"]))
    assert all(t for t, _ in want)
    for o in para["outs"]:
        assert _as_result(o["json"]["rec/tp"]) == want
        assert _as_result(o["json"]["rec/whole"]) == want


def test_tp_recognizer_hotwords_match_jax(para):
    """Per-segment hotword embeddings (one segment with 3 rows) through
    the dp x tp recognizer: JAX's results."""
    segs = para["segs"]
    hw = [None, para["inputs"]["hw_emb"][0, :3]] + [None] * (len(segs) - 2)
    want = _as_result(_jax_rec(para).recognize_batch(segs, hw_embs=hw))
    for o in para["outs"]:
        assert _as_result(o["json"]["rec/tp/hotword"]) == want


def test_tp_recognizer_lm_rows_match_unsharded(para):
    """An LM decoder on every segment: the dp x tp recognizer's rows
    (gathered over dp) give the unsharded recognizer's texts."""
    for o in para["outs"]:
        got = o["json"]["rec/tp/lm"]
        assert got == o["json"]["rec/whole/lm"]
        assert [t for t, _ in got] != [t for t, _ in o["json"]["rec/tp"]]


@pytest.mark.parametrize("what", ["vocab", "quantize_after"])
def test_tp_refusals_pinned(para, what):
    """The port's shard_params refuses a vocab of 66 over tp 4, with the
    shape named (JAX's device_put refuses it too); quantize_params
    refuses a shard, naming JAX's whole-axis scales (quantize, then
    shard)."""
    msg = para["outs"][0]["json"]["refusals"][what]
    assert msg is not None
    if what == "vocab":
        assert "(32, 66)" in msg
        tree = _tree(_jcfg(4, vocab=66), 0)
        with pytest.raises(ValueError, match="divisible"):
            jsharding.shard_params(tree, jsharding.make_mesh(8, tp=4))
    else:
        assert "tensor-parallel shard" in msg and "whole input" in msg


# -- tp 4 over 2 heads: the attention modules stay whole ---------------------

def _jax_sharded_forward(para, name, mesh):
    """JAX's apply on the tree placed by its rules on `mesh` (GSPMD)."""
    cfg, tree = para["trees"][name]
    inp = para["inputs"]
    return jparaformer.apply(
        jsharding.shard_params(tree, mesh), cfg, jnp.asarray(inp["feats"]),
        jnp.asarray(inp["lengths"]), hw_emb=jnp.asarray(inp["hw_emb"]),
        hw_mask=jnp.asarray(inp["hw_mask"]),
        max_tokens=inp["feats"].shape[1] // 2 + 8)


def test_heads_tp_forward_matches_jax(para):
    """2 heads over tp 4 (JAX: make_mesh(8, tp=4)): token_num equal, the
    logits, upsampled alphas and peaks within RANGE_TOL of their range,
    on every rank."""
    ref = _jax_sharded_forward(para, "tp2", jsharding.make_mesh(8, tp=4))
    want_n = np.asarray(ref.token_num)
    for o in para["outs"]:
        np.testing.assert_array_equal(o["heads/tp/token_num"], want_n)
        for k, n in enumerate(want_n):
            _within_range(o["heads/tp/logits"][k, :n],
                          np.asarray(ref.logits)[k, :n])
        _within_range(o["heads/tp/us_alphas"], ref.us_alphas)
        _within_range(o["heads/tp/us_cif_peak"], ref.us_cif_peak)


def test_heads_tp_keeps_attention_whole(para):
    """Every attention module (the encoder's, the decoder's cross and the
    hotword block's) stays whole on each rank with no collective; the
    FFNs and the vocab head are sliced: one all-reduce per FFN, one
    all-gather for the vocab."""
    js = para["outs"][0]["json"]
    assert js["heads/shapes"] == {"qkv": [560, 96], "w1": [32, 32],
                                  "vocab": [32, 16]}
    assert js["heads/whole_units"] == [
        "decoder.blocks.0.cross", "decoder.blocks.1.cross",
        "decoder.hotword.cross", "encoder.first.att", "encoder.rest.0.att"]
    assert js["heads/collectives"] == {"all_reduce": 2 + 2 + 1,
                                       "all_gather": 1, "halo": 0,
                                       "broadcast": 0}


def test_heads_tp_recognizer_matches_jax(para):
    """The dp 1 x tp 4 recognizer over a 2-head model: JAX's recognizer on
    make_mesh(8, tp=4), texts and timestamps, on every rank."""
    cfg, tree = para["trees"]["rec"]
    want = _as_result(JOffline(tree, cfg, make_test_vocab(cfg.vocab_size),
                               tp_mesh=jsharding.make_mesh(8, tp=4)
                               ).recognize_batch(para["segs"]))
    assert all(t for t, _ in want)
    for o in para["outs"]:
        assert _as_result(o["json"]["rec/heads"]) == want


# -- an int8 tree under tp: every unit whole -------------------------------

INT8_FORMS = {"w8a16": True, "w8a8": False}


@pytest.mark.parametrize("form", INT8_FORMS)
def test_int8_tp_forward_equals_unsharded(para, form):
    """shard_params of an int8 tree at tp 2 slices nothing, and its
    forward is bit-equal to the unsharded int8 forward."""
    o = para["outs"][0]
    assert o["json"][f"int8/{form}/sliced"] == 0
    for what in ("logits", "token_num"):
        np.testing.assert_array_equal(o[f"int8/{form}/tp/{what}"],
                                      o[f"int8/{form}/whole/{what}"])


@pytest.mark.parametrize("form", INT8_FORMS)
def test_int8_tp_recognizer_matches_jax(para, form):
    """The dp 2 x tp 2 recognizer on the int8 tree: JAX's TP recognizer
    on its quantized tree (make_mesh(8, tp=2), its int8 leaves whole)."""
    from asr2pass_tpu.utils import quantize_params as jquantize

    cfg, tree = para["trees"]["tp4"]
    jtree = jquantize(tree, weight_only=INT8_FORMS[form])
    want = _as_result(JOffline(jtree, cfg, make_test_vocab(cfg.vocab_size),
                               tp_mesh=jsharding.make_mesh(8, tp=2)
                               ).recognize_batch(para["segs"]))
    assert all(t for t, _ in want)
    for o in para["outs"]:
        assert _as_result(o["json"][f"rec/int8/{form}"]) == want


# -- tp with sp ----------------------------------------------------------------

def _jax_tpsp(para, tp, sp):
    """JAX's recognizer with tp_mesh over its first `tp` devices and/or an
    sp_mesh over its first `sp` (0: without)."""
    from jax.sharding import Mesh

    cfg, tree = para["trees"]["rec"]
    kw = {}
    if tp:
        kw["tp_mesh"] = jsharding.make_mesh(tp, tp=tp)
    if sp:
        kw.update(sp_mesh=Mesh(np.array(jax.devices()[:sp]), ("sp",)),
                  sp_threshold=SP_THRESHOLD)
    return JOffline(tree, cfg, make_test_vocab(cfg.vocab_size), **kw)


def _tpsp_segs(para):
    return [para["segs"][0], para["inputs"]["long"]]


@pytest.mark.parametrize("sp", [2, 4])
def test_tp_sp_recognizer_matches_jax(para, sp):
    """tp 2 with sp 2 and sp 4, sp_threshold lowered to 64: the 1 s
    segment through the TP path and the 6 s one through SP give JAX's
    recognizer given both meshes (2 x 2); at 2 x 4, which JAX refuses
    (test_jax_tp_sp_on_other_devices_fails), JAX's tp 2 and sp 4
    recognizers, each alone. With and without hotwords on the short
    segment; texts and timestamps, on every rank."""
    segs = _tpsp_segs(para)
    hw = [para["inputs"]["hw_emb"][0, :3], None]
    refs = ([_jax_tpsp(para, 2, 2)] if sp == 2 else
            [_jax_tpsp(para, 2, 0), _jax_tpsp(para, 0, 4)])
    for ref in refs:
        want = _as_result(ref.recognize_batch(segs))
        want_hw = _as_result(ref.recognize_batch(segs, hw_embs=hw))
        assert all(t for t, _ in want)
        for o in para["outs"]:
            assert _as_result(o["json"][f"rec/tpsp{sp}"]) == want
            assert _as_result(o["json"][f"rec/tpsp{sp}/hotword"]) == want_hw
    assert _as_result(para["outs"][0]["json"]["rec/whole/tpsp"]) == want


@pytest.mark.parametrize("sp", [2, 4])
def test_tp_sp_call_runs_both_paths(para, sp):
    """One recognize_batch call of tp with sp ran the sequence-parallel
    encoder (a halo exchange a block) on the encoder gathered whole from
    the tp shards (7 sliced keys a block), and the TP forward and
    decoder (all-reduces), the same on every rank."""
    got = [o["json"][f"rec/tpsp{sp}/collectives"] for o in para["outs"]]
    assert all(g == got[0] for g in got)
    assert got[0]["halo"] == 2
    assert got[0]["all_gather"] >= 2 * 7 + 2 * 2 + 1
    assert got[0]["all_reduce"] > 0


def test_jax_tp_sp_on_other_devices_fails():
    """A fault of the reference: JAX's recognizer given a tp_mesh over 2
    devices and an sp_mesh over 4 places the params on the first and the
    encoder's input on the second, and the SP jit refuses them."""
    from jax.sharding import Mesh

    cfg = _jcfg(2)
    tree = _tree(cfg, 0)
    rec = JOffline(tree, cfg, make_test_vocab(cfg.vocab_size),
                   tp_mesh=jsharding.make_mesh(2, tp=2),
                   sp_mesh=Mesh(np.array(jax.devices()[:4]), ("sp",)),
                   sp_threshold=SP_THRESHOLD)
    with pytest.raises(ValueError, match="incompatible devices"):
        rec.recognize_batch([speechy(6.0, 40)])


# ---------------------------------------------------------------------------
# SenseVoice at tp 2 and 4 with the sharded prune (one spawn)
# ---------------------------------------------------------------------------

SVS_TPS = [2, 4]
# ids whose log-probs the sharded prune also returns: in every rank's
# columns at tp 4, one repeated (the recognizer pads its set so)
HW_IDS = [3, 7, 8, 21, 40, 63, 3, 3]
# the mixed batch: two length buckets, contexts on items 0 and 3
MIXED_SECONDS = (1.0, 1.3, 4.5, 0.8)
MIXED_CONTEXTS = [True, False, False, True]
MIXED_LANGS = ["en", None, "ja", "auto"]


@pytest.fixture(scope="module")
def svs(tmp_path_factory):
    rng = np.random.default_rng(3)
    inputs, trees = {}, {}
    for tp in SVS_TPS:
        cfg = _svs_jcfg(tp)
        trees[tp] = (cfg, _tree(cfg, 10 + tp, jsv.init))
        _put(inputs, f"svs{tp}", trees[tp][1])
    inputs["feats"] = rng.standard_normal((3, 24, 560)).astype(np.float32)
    inputs["lengths"] = np.array([24, 19, 11], np.int64)
    inputs["lid"] = np.array([0, 3, 4], np.int64)
    inputs["tn"] = np.array([14, 15, 14], np.int64)
    inputs["wave"] = speechy(1.0, 5)
    for i, sec in enumerate(MIXED_SECONDS):
        inputs[f"mixed{i}"] = speechy(sec, 30 + i)
    inputs["n_mixed"] = np.array(len(MIXED_SECONDS))
    outs = spawn("sensevoice_tp", tmp_path_factory.mktemp("svs"), WORLD,
                 inputs, {"tps": SVS_TPS, "k": PRUNE_K, "hw_ids": HW_IDS,
                          "hot": _hot(), "contexts": MIXED_CONTEXTS,
                          "langs": MIXED_LANGS})
    return dict(outs=outs, trees=trees, inputs=inputs)


def _hot():
    vocab = make_test_vocab(64)
    return {vocab.id2token(7) + vocab.id2token(8): 40.0}


def _jax_svs(svs, tp):
    cfg, tree = svs["trees"][tp]
    inp = svs["inputs"]
    return jsv.apply(tree, cfg, jnp.asarray(inp["feats"]),
                     *(jnp.asarray(inp[k]) for k in ("lengths", "lid",
                                                      "tn")))


def _same_sets(t_ids, t_lp, j_ids, j_lp, lengths):
    """Each valid frame's candidates as sets of ids, log-probs per id
    within LOGP_ATOL (top-k orders ties its own way; past a row's length
    the logits are the bias alone, a 64-way tie)."""
    t_ids, j_ids = np.asarray(t_ids), np.asarray(j_ids)
    t_lp, j_lp = np.asarray(t_lp), np.asarray(j_lp)
    assert t_ids.shape == j_ids.shape
    for idx in np.ndindex(*t_ids.shape[:-1]):
        if idx[1] >= lengths[idx[0]]:
            continue
        assert set(t_ids[idx].tolist()) == set(j_ids[idx].tolist())
        ot, oj = np.argsort(t_ids[idx]), np.argsort(j_ids[idx])
        np.testing.assert_allclose(t_lp[idx][ot], j_lp[idx][oj], rtol=0,
                                   atol=LOGP_ATOL)


@pytest.mark.parametrize("tp", SVS_TPS)
def test_svs_tp_logits_and_greedy_match_jax(svs, tp):
    """Gathered logits within RANGE_TOL of JAX's range on valid frames;
    greedy ids, counts and meta equal JAX's greedy_ids."""
    ref = _jax_svs(svs, tp)
    o = svs["outs"][0]
    lens = np.asarray(ref.lengths)
    for k, n in enumerate(lens):
        _within_range(o[f"svs{tp}/logits"][k, :n],
                      np.asarray(ref.logits)[k, :n])
    jids, jcounts, jmeta = jsv.greedy_ids(ref)
    np.testing.assert_array_equal(o[f"svs{tp}/counts"], np.asarray(jcounts))
    np.testing.assert_array_equal(o[f"svs{tp}/meta"], np.asarray(jmeta))
    for k, n in enumerate(np.asarray(jcounts)):
        np.testing.assert_array_equal(o[f"svs{tp}/ids"][k, :n],
                                      np.asarray(jids)[k, :n])


@pytest.mark.parametrize("tp", SVS_TPS)
def test_svs_shards_are_the_ranks_vocab_columns(svs, tp):
    """Rank r's shard logits are columns [r V/tp, (r+1) V/tp) of the
    gathered logits (ranks of a dp x tp mesh pair up by tp rank)."""
    v = 64 // tp
    for rank, o in enumerate(svs["outs"]):
        r = rank % tp
        np.testing.assert_array_equal(
            o[f"svs{tp}/shard_logits"],
            o[f"svs{tp}/logits"][..., r * v: (r + 1) * v])


@pytest.mark.parametrize("tp", SVS_TPS)
def test_sharded_prune_matches_jax(svs, tp):
    """The sharded prune's (id, log-prob) sets equal JAX's
    ctc_first_prune_sharded on a tp mesh of its devices (on JAX's logits)
    and the port's whole-vocab ctc_first_prune, on every rank; with an id
    set, the same sets and the ids' log-probs within LOGP_ATOL of JAX's
    ctc_gather_logp and of the port's ctc_first_prune_gather."""
    ref = _jax_svs(svs, tp)
    mesh = jsharding.make_mesh(tp, tp=tp)
    jids, jlp = jctc.ctc_first_prune_sharded(ref.logits, mesh, "tp",
                                             k=PRUNE_K)
    jhw = np.asarray(jctc.ctc_gather_logp(ref.logits,
                                          jnp.asarray(HW_IDS, jnp.int32)))
    lens = np.asarray(ref.lengths)
    for o in svs["outs"]:
        for kind in ("prune", "gather"):
            got = o[f"svs{tp}/{kind}_ids"], o[f"svs{tp}/{kind}_logp"]
            _same_sets(*got, jids, jlp, lens)
            _same_sets(*got, o[f"svs{tp}/whole_prune_ids"],
                       o[f"svs{tp}/whole_prune_logp"], lens)
        for k, n in enumerate(lens):
            for want in (jhw, o[f"svs{tp}/whole_hw"]):
                np.testing.assert_allclose(o[f"svs{tp}/gather_hw"][k, :n],
                                           want[k, :n], rtol=0,
                                           atol=LOGP_ATOL)
    # two all-reduces (max, exp-sum) and two all-gathers (scores, ids);
    # the id set's log-probs add one all-reduce
    js = svs["outs"][0]["json"]
    assert js[f"svs{tp}/prune_collectives"] == {
        "all_reduce": 2, "all_gather": 2, "halo": 0, "broadcast": 0}
    assert js[f"svs{tp}/prune_gather_collectives"] == {
        "all_reduce": 3, "all_gather": 2, "halo": 0, "broadcast": 0}


@pytest.mark.parametrize("tp", SVS_TPS)
def test_svs_tp_exchanges_no_whole_logits(svs, tp):
    """Greedy ids take two all-gathers of [B, T] (the ranks' maxima and
    their ids), and the beam-only recognizer adds only the sharded
    prune's collectives to the forward's: no all-gather of the logits."""
    js = svs["outs"][0]["json"]
    assert js[f"svs{tp}/greedy_collectives"] == {
        "all_reduce": 0, "all_gather": 2, "halo": 0, "broadcast": 0}
    fwd = js[f"svs{tp}/forward_collectives"]
    assert js[f"svs{tp}/beam_collectives"] == {
        "all_reduce": fwd["all_reduce"] + 2,
        "all_gather": fwd["all_gather"] + 2 + 2, "halo": 0,
        "broadcast": 0}


@pytest.mark.parametrize("tp", SVS_TPS)
def test_svs_tp_beam_matches_jax(svs, tp):
    """The beam-4 recognizer through the sharded prune: JAX's text and
    meta (tests/test_sensevoice_ctc.py's sharded-beam case)."""
    cfg, tree = svs["trees"][tp]
    ref = JSvs(tree, cfg, make_test_vocab(cfg.vocab_size), lang="zh",
               beam=4)
    (want, _, meta), = ref.recognize_batch([svs["inputs"]["wave"]],
                                           with_meta=True)
    for o in svs["outs"]:
        (got, _, got_meta), = o["json"][f"svs{tp}/beam"]
        assert got == want
        assert list(got_meta) == list(meta)


@pytest.mark.parametrize("beam", [0, 4])
@pytest.mark.parametrize("tp", SVS_TPS)
def test_svs_tp_mixed_batch_matches_jax(svs, tp, beam):
    """Greedy and context-biased beam items in one batch of two length
    buckets, with per-item langs, through the sharded recognizer: JAX's
    texts and meta (the context units' log-probs come from the sharded
    gather)."""
    from asr2pass_tpu.decode.context_graph import ContextGraph

    cfg, tree = svs["trees"][tp]
    ref = JSvs(tree, cfg, make_test_vocab(cfg.vocab_size), lang="zh",
               beam=beam)
    waves = [svs["inputs"][f"mixed{i}"] for i in range(len(MIXED_SECONDS))]
    ctx = [ContextGraph().build(_hot()) if c else None
           for c in MIXED_CONTEXTS]
    want = ref.recognize_batch(waves, with_meta=True, contexts=ctx,
                               langs=MIXED_LANGS)
    for o in svs["outs"]:
        got = o["json"][f"svs{tp}/mixed{beam}"]
        assert [(t, list(m)) for t, _, m in got] == \
            [(t, list(m)) for t, _, m in want]
