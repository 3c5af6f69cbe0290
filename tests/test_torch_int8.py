"""The port's int8 Paraformer against the JAX package on the CPU:
utils.quantize_params (w8a8 `w_q` and weight-only `w_q8`), the quantized
dense layer, whole forwards with and without the bicif timestamp head,
int8 model directories in both directions, the padded torch._int_mm
route, and ASR2PASS_BF16_SCORES.

The JAX package's quantized tree fails in the timestamp head (its skip
list names `us_conv`, the conv is `us_cnn`); the port skips `us_cnn`.
The timestamp model is held to JAX's intended arithmetic: the JAX tree
with `us_cnn` restored to float and a zero `w` beside each BLSTM `wh`
(dense takes the `w_q` branch first, so only its width is read).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.models import layers as jlayers
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.runtime.offline_asr import (
    ParaformerOffline as JParaformerOffline)
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu.utils import cast_floats as jcast_floats
from asr2pass_tpu.utils import quantize_params as jquantize
from asr2pass_tpu_torch.models import layers as tlayers
from asr2pass_tpu_torch.models import paraformer as tparaformer
from asr2pass_tpu_torch.ops import int8 as tint8
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from asr2pass_tpu_torch.runtime.offline_api import (
    OfflineRecognizer as TOfflineRecognizer)
from asr2pass_tpu_torch.runtime.offline_asr import (
    ParaformerOffline as TParaformerOffline)
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from asr2pass_tpu_torch.utils import cast_floats, quantize_params
from torch_parity import jax_params, t, tiny_cfgs

FORMS = {"w8a8": False, "w8a16": True}
# w8a16 keeps every activation in fp32: the forward differs from JAX's by
# fp32 sums in another order, as the float model does (test_torch_model)
W8A16_TOL = 1e-4
# w8a8 rounds every dense layer's input to 1/127 of its row's max. An
# input that differs from JAX's by one fp32 ulp (an attention or a layer
# norm summed in another order) can round to the other int8 step; that
# flip is one draw of the rounding error again, and later layers carry it
# on. Where no flip happens the logits are bit-equal to JAX's. So the
# port's w8a8 logits are held to within w8a8's own error against the
# float model (a share of at most 1; 0-0.64 of it over 12 model and input
# seeds here), and the ids to JAX's wherever JAX's top-two margin exceeds
# twice the logits' difference. The limit cannot be tighter: the flips are
# fresh draws of w8a8's own rounding error, so the whole forward's
# distance from JAX is of the size of w8a8's distance from the float
# model, and so is that of a w8a16 forward in w8a8's place. This check
# therefore does not tell the two forms apart; the arithmetic of every
# w8a8 layer is held to JAX's bit for bit on the forward's own
# activations by test_every_w8a8_layer_of_the_forward_matches_jax
W8A8_SHARE_OF_QUANT_ERROR = 1.0
W8A8_US_ALPHAS_TOL = 5e-3


@pytest.fixture(scope="module")
def hw_model():
    """paraformer_tiny with the hotword block, no timestamp head."""
    jcfg, tcfg = tiny_cfgs(hotword=True)
    return jcfg, tcfg, jax_params(jcfg, 0)


@pytest.fixture(scope="module")
def ts_model():
    """paraformer_tiny with the bicif timestamp head."""
    jcfg, tcfg = tiny_cfgs(timestamp=True)
    return jcfg, tcfg, jax_params(jcfg, 1)


def _flat(tree):
    out = {}
    tzoo._flatten(tree, "", out)
    return out


def _as_f32(a):
    """A JAX array (bf16 included) as numpy float32 or its own int type;
    bf16 to float32 is exact, so equal float32 means equal bits."""
    a = np.asarray(a)
    return a if a.dtype.kind in "iu" else a.astype(np.float32)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("container", ["state_dict", "module"])
def test_quantize_params_matches_jax(hw_model, form, dtype, container):
    """Cast, then quantize (bench.py's bf16 route): every int8 weight
    equal, every scale bit-equal, the same keys, in both containers."""
    jcfg, tcfg, tree = hw_model
    jdt = getattr(jnp, dtype)
    ref = _flat(jquantize(jcast_floats(tree, jdt), weight_only=FORMS[form]))
    sd = tzoo.params_from_jax(tree)
    if container == "module":
        model = tparaformer.from_state_dict(sd, tcfg, device="cpu")
        got = quantize_params(cast_floats(model, getattr(torch, dtype)),
                              weight_only=FORMS[form])
        assert isinstance(got, torch.nn.Module)
    else:
        got = quantize_params(cast_floats(sd, getattr(torch, dtype)),
                              weight_only=FORMS[form])
    got = _flat(tzoo.params_to_jax(got))
    assert got.keys() == ref.keys()
    key = "w_q8" if FORMS[form] else "w_q"
    n_int8 = 0
    for k, r in ref.items():
        r = _as_f32(r)
        assert got[k].dtype == r.dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
        n_int8 += k.endswith(key)
    assert n_int8 >= 15
    assert "encoder/rest/att/qkv/" + key in got
    assert "encoder/rest/att/fsmn/taps" in got     # FSMN taps stay float


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_out,bias", [(48, True), (1, True), (20, False)])
def test_quantized_dense_matches_jax(form, n_out, bias):
    """One dense layer on a [B, T, K] input. w8a8 equals JAX's to the bit
    (the same elementwise steps around an exact integer product); w8a16
    within 1e-6 (its fp32 product is summed in another order)."""
    rng = np.random.default_rng(n_out)
    w = rng.uniform(-0.2, 0.2, (64, n_out)).astype(np.float32)
    p = {"w": w}
    if bias:
        p["b"] = rng.standard_normal(n_out).astype(np.float32)
    x = (rng.standard_normal((3, 7, 64)) * 2).astype(np.float32)
    x[0, 0] = 0.0                    # a zero row: the 1e-6 scale floor
    ref = np.asarray(jlayers.dense(jquantize(p, FORMS[form]),
                                   jnp.asarray(x)))
    mod = tlayers.Dense(64, n_out, bias=bias, device="cpu")
    mod.load_state_dict({k: t(v) for k, v in p.items()})
    quantize_params(mod, weight_only=FORMS[form])
    assert mod.weight_key == ("w_q8" if FORMS[form] else "w_q")
    assert mod.weight.dtype == torch.int8
    assert not hasattr(mod, "w")
    with torch.no_grad():
        got = tlayers.dense(mod, t(x)).numpy()
    if FORMS[form]:
        # an fp32 product, summed in another order than XLA's
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def _forward_pair(jcfg, tcfg, jtree, tmodel, t_len=300, seed=7):
    rng = np.random.default_rng(seed)
    lens = np.array([t_len, t_len * 4 // 7, 0])
    feats = rng.standard_normal((3, t_len, 560)).astype(np.float32)
    kw = dict(max_tokens=t_len // 2 + 8)
    ref = jparaformer.apply(jtree, jcfg, jnp.asarray(feats),
                            jnp.asarray(lens), **kw)
    with torch.no_grad():
        got = tparaformer.apply(tmodel, tcfg, t(feats), torch.as_tensor(lens),
                                **kw)
    return feats, lens, ref, got


def _check_forward(form, ref, got, ref_float=None):
    """token_num equal; w8a16: ids equal, logits within W8A16_TOL; w8a8:
    logits within W8A8_SHARE_OF_QUANT_ERROR of the quantization error,
    ids equal at every token whose JAX margin exceeds twice the logits'
    difference."""
    n_tok = np.asarray(ref.token_num)
    np.testing.assert_array_equal(got.token_num.numpy(), n_tok)
    assert n_tok[0] > 20
    for b, n in enumerate(n_tok[n_tok > 0]):
        rl = np.asarray(ref.logits)[b, :n]
        gl = got.logits[b, :n].numpy()
        if form == "w8a16":
            np.testing.assert_allclose(gl, rl, rtol=W8A16_TOL,
                                       atol=W8A16_TOL)
            np.testing.assert_array_equal(gl.argmax(-1), rl.argmax(-1))
            continue
        diff = np.abs(gl - rl).max()
        quant_err = np.abs(rl - np.asarray(ref_float.logits)[b, :n]).max()
        assert diff <= W8A8_SHARE_OF_QUANT_ERROR * quant_err, (diff,
                                                               quant_err)
        top2 = np.sort(rl, axis=-1)[:, -2:]
        decisive = top2[:, 1] - top2[:, 0] > 2 * diff
        same = gl.argmax(-1) == rl.argmax(-1)
        assert decisive.any() and same[decisive].all()


def _record_w8a8(monkeypatch):
    """Record every w8a8 dense call of the port's models as (layer, input,
    output), through each models module's reference to layers.dense."""
    calls = []
    orig = tlayers.dense

    def recording(p, x):
        y = orig(p, x)
        if p.weight_key == "w_q":
            calls.append((p, x.detach().clone(), y.detach().clone()))
        return y

    for name, mod in list(sys.modules.items()):
        if (name.startswith("asr2pass_tpu_torch.models")
                and getattr(mod, "dense", None) is orig):
            monkeypatch.setattr(mod, "dense", recording)
    return calls


@pytest.mark.parametrize("model", ["hw_model", "ts_model"])
def test_every_w8a8_layer_of_the_forward_matches_jax(request, monkeypatch,
                                                     model):
    """Every w8a8 dense call of a whole forward, on the activations the
    forward gave it, equals JAX's dense on the same input and weights to
    the bit: the per-row quantization, the int8 product (padded where
    torch._int_mm needs it) and the rescale. A w8a16 product in its place
    differs at every call with a non-zero input, so the check tells the
    two forms apart, which the whole forward's logits cannot (see
    W8A8_SHARE_OF_QUANT_ERROR)."""
    jcfg, tcfg, tree = request.getfixturevalue(model)
    tmodel = tparaformer.from_state_dict(
        quantize_params(tzoo.params_from_jax(tree)), tcfg, device="cpu")
    calls = _record_w8a8(monkeypatch)
    t_len = 140
    feats = np.random.default_rng(3).standard_normal(
        (2, t_len, 560)).astype(np.float32)
    with torch.no_grad():
        tparaformer.apply(tmodel, tcfg, t(feats),
                          torch.as_tensor([t_len, t_len * 4 // 7]),
                          max_tokens=t_len // 2 + 8)
    shapes = set()
    controls = 0
    for p, x, y in calls:
        jp = {"w_q": jnp.asarray(p.w_q.numpy()),
              "scale": jnp.asarray(p.scale.detach().numpy())}
        if p.b is not None:
            jp["b"] = jnp.asarray(p.b.detach().numpy())
        ref = np.asarray(jlayers.dense(jp, jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(y.numpy(), ref)
        if x.abs().max() > 0:
            w8a16 = dict(jp, w_q8=jp.pop("w_q"))
            assert not np.array_equal(
                np.asarray(jlayers.dense(w8a16, jnp.asarray(x.numpy()))),
                ref)
            controls += 1
        shapes.add((x.reshape(-1, x.shape[-1]).shape[0], *p.w_q.shape))
    # the forms torch._int_mm cannot take unpadded are among them: the
    # predictor's 1-wide head, and with the timestamp head the BLSTM's
    # per-step product at 2 rows
    assert any(n == 1 for _, _, n in shapes)
    if model == "ts_model":
        assert any(m == 2 for m, _, _ in shapes)
    assert controls > len(calls) // 2 and len(shapes) >= 6


@pytest.mark.parametrize("form", FORMS)
def test_int8_forward_matches_jax(hw_model, form):
    """The whole forward of the hotword model (no hotword embeddings) on a
    ragged batch with a length-0 row."""
    jcfg, tcfg, tree = hw_model
    jtree = jquantize(tree, weight_only=FORMS[form])
    model = tparaformer.from_state_dict(
        quantize_params(tzoo.params_from_jax(tree), FORMS[form]), tcfg,
        device="cpu")
    feats, lens, ref, got = _forward_pair(jcfg, tcfg, jtree, model)
    ref_float = jparaformer.apply(tree, jcfg, jnp.asarray(feats),
                                  jnp.asarray(lens), max_tokens=158)
    _check_forward(form, ref, got, ref_float)


def _jax_intended(tree, weight_only):
    """JAX's quantized timestamp tree as its skip list means it: us_cnn
    float, and a zero w beside each BLSTM wh for lstm_apply's width."""
    jtree = jquantize(tree, weight_only=weight_only)
    pred = jtree["predictor"]
    pred["us_cnn"] = tree["predictor"]["us_cnn"]
    for d in ("fw", "bw"):
        wh = pred["blstm"][d]["wh"]
        wh["w"] = np.zeros(wh["w_q8" if weight_only else "w_q"].shape,
                           np.float32)
    return jtree


@pytest.mark.parametrize("form", FORMS)
def test_timestamp_model_runs_quantized(ts_model, form):
    """The port quantizes the timestamp model (us_cnn kept float) and
    matches JAX's intended arithmetic: logits and token_num as above,
    the upsampled alphas within W8A16_TOL or W8A8_US_ALPHAS_TOL."""
    jcfg, tcfg, tree = ts_model
    model = quantize_params(tparaformer.from_state_dict(
        tzoo.params_from_jax(tree), tcfg, device="cpu"), FORMS[form])
    assert model.predictor.us_cnn.w.dtype == torch.float32
    assert model.predictor.blstm["fw"].wh.weight.dtype == torch.int8
    feats, lens, ref, got = _forward_pair(
        jcfg, tcfg, _jax_intended(tree, FORMS[form]), model, t_len=140)
    ref_float = jparaformer.apply(tree, jcfg, jnp.asarray(feats),
                                  jnp.asarray(lens), max_tokens=78)
    _check_forward(form, ref, got, ref_float)
    for b in range(2):
        n = int(lens[b]) * 3
        ra = np.asarray(ref.us_alphas)[b, :n]
        ga = got.us_alphas[b, :n].numpy()
        if form == "w8a16":
            np.testing.assert_allclose(ga, ra, rtol=W8A16_TOL, atol=1e-5)
        else:
            # renormalised to token_num, the upsampled alphas carry the
            # flips' noise but hardly w8a8's own error (3e-4 here): held
            # to W8A8_US_ALPHAS_TOL of their largest value (measured 0.12 %)
            np.testing.assert_allclose(ga, ra, rtol=0,
                                       atol=W8A8_US_ALPHAS_TOL * ra.max())


def test_jax_quantized_timestamp_tree_raises(ts_model):
    """The difference the port fixes: the JAX package's own quantized
    timestamp tree fails in the bicif head (either form; w8a16 here,
    which reaches the head sooner on the CPU)."""
    jcfg, _, tree = ts_model
    feats = np.zeros((1, 64, 560), np.float32)
    with pytest.raises(KeyError, match="'w'"):
        jparaformer.apply(jquantize(tree, weight_only=True), jcfg,
                          jnp.asarray(feats), jnp.asarray([64]))


@pytest.mark.parametrize("form", FORMS)
def test_int8_dir_from_jax(hw_model, tmp_path, form):
    """An int8 model dir that JAX saved loads through load_offline_bundle
    into a quantized model and transcribes to JAX's text; the port saves
    it back with its int8 arrays and stacked scales unchanged."""
    jcfg, tcfg, tree = hw_model
    jtree = jax_tree_numpy(jquantize(tree, weight_only=FORMS[form]))
    vocab = make_test_vocab(jcfg.vocab_size)
    d = str(tmp_path / "int8")
    jzoo.save_offline_bundle(d, jtree, jcfg, vocab.tokens)
    bundle = tzoo.load_offline_bundle(d)
    key = "w_q8" if FORMS[form] else "w_q"
    assert bundle.params[f"encoder.rest.0.att.qkv.{key}"].dtype == torch.int8
    tasr = TParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                              device="cpu")
    qkv = tasr.model.encoder.rest[0].att.qkv
    assert qkv.weight_key == key
    if key == "w_q":      # kept column-major for torch._int_mm's fast path
        assert qkv.w_q.stride() == (1, qkv.w_q.shape[0])
    jasr = JParaformerOffline(jtree, jcfg, vocab)
    rng = np.random.default_rng(5)
    segs = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
            for s in (2.0, 3.5)]
    ref = [text for text, _ in jasr.recognize_batch(segs)]
    got = [text for text, _ in tasr.recognize_batch(segs)]
    assert all(ref) and got == ref
    back = _flat(tzoo.params_to_jax(tasr.model))
    for k, v in _flat(jtree).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back[f"encoder/rest/att/qkv/{key}"].dtype == np.int8
    assert back["encoder/rest/att/qkv/scale"].ndim == 2       # [L, out]


def jax_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("container", ["module", "state_dict"])
def test_recognizer_serves_quantized(ts_model, container):
    """ParaformerOffline and OfflineRecognizer take a quantized module or
    state dict of the timestamp model (w8a16, whose ids equal JAX's):
    the text and stamps of JAX's intended tree."""
    jcfg, tcfg, tree = ts_model
    vocab = make_test_vocab(jcfg.vocab_size)
    sd = quantize_params(tzoo.params_from_jax(tree), weight_only=True)
    params = (sd if container == "state_dict" else
              tparaformer.from_state_dict(sd, tcfg, device="cpu"))
    tasr = TParaformerOffline(params, tcfg, TVocab(vocab.tokens),
                              device="cpu")
    jasr = JParaformerOffline(_jax_intended(tree, True), jcfg, vocab)
    wave = (np.random.default_rng(9).standard_normal(48000) * 0.1
            ).astype(np.float32)
    ref = jasr.recognize_batch([wave])
    assert ref[0][0] and ref[0][1]
    assert tasr.recognize_batch([wave]) == ref
    assert TOfflineRecognizer(tasr).transcribe(wave).text == ref[0][0]


@pytest.mark.parametrize("m,k,n", [(5, 64, 1), (16, 512, 8404),
                                   (3, 256, 1024), (40, 70, 13),
                                   (17, 512, 1536)])
def test_int_mm_padding_is_exact(m, k, n):
    """The zero-padded torch._int_mm equals the plain int32 product, and
    the shape it is given meets _int_mm's rules (rows > 16, inner and
    output widths multiples of 8)."""
    rng = np.random.default_rng(m * n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    mp, kp, np_ = tint8.int_mm_shape(m, k, n)
    assert mp > 16 and kp % 8 == 0 and np_ % 8 == 0
    assert (mp, kp, np_) >= (m, k, n)
    ref = tint8.int8_matmul_plain(a, b)
    assert ref.dtype == torch.int32
    assert torch.equal(tint8.int_mm_padded(a, b), ref)
    assert torch.equal(tint8.int8_matmul(a, b), ref)
    # the weight padded once (a Dense's w_q_mm), the result sliced to n
    b_mm = tint8.pad_weight(b)
    assert b_mm.shape == (kp, np_) and b_mm.stride(0) == 1
    assert torch.equal(tint8.int_mm_padded(a, b_mm, n), ref)
    assert torch.equal(tint8.int8_matmul(a, b_mm, n), ref)
    # the CPU path is the plain version: no _int_mm call is counted
    assert not tint8.launch_shapes()


@pytest.mark.parametrize("n_out", [1, 8404, 48])
def test_dense_keeps_its_weight_padded_once(n_out):
    """A w8a8 Dense whose output width torch._int_mm refuses holds its
    weight zero-padded once, column-major (w_q_mm), outside the state dict
    and made again by a load; a Dense with legal widths holds none."""
    mod = tlayers.Dense(64, n_out, device="cpu")
    mod.quantize_()
    sd = mod.state_dict()
    assert set(sd) == {"w_q", "scale", "b"}
    assert sd["w_q"].shape == (64, n_out)
    legal = n_out % tint8.INT_MM_MULTIPLE == 0
    assert hasattr(mod, "w_q_mm") != legal
    if legal:
        return
    w_mm = mod.w_q_mm
    assert w_mm.shape == (64, -(-n_out // 8) * 8) and w_mm.stride(0) == 1
    assert torch.equal(w_mm[:, :n_out], mod.w_q)
    assert not w_mm[:, n_out:].any()
    fresh = tlayers.Dense(64, n_out, device="cpu")
    fresh.quantize_()
    fresh.load_state_dict(sd)
    assert torch.equal(fresh.w_q_mm, w_mm)


@pytest.mark.parametrize("bf16_scores", ["0", "1"])
def test_bf16_scores_match_jax(monkeypatch, bf16_scores):
    """ASR2PASS_BF16_SCORES=1 keeps a bf16 layer's scores in bf16 with a
    -30000 fill, read at each call as in JAX; both settings match JAX's
    SAN-M attention on a masked bf16 batch, and they differ."""
    rng = np.random.default_rng(11)
    d, heads, t_len = 64, 4, 40
    tree = {"qkv": {"w": rng.uniform(-0.3, 0.3, (d, 3 * d)),
                    "b": rng.standard_normal(3 * d) * 0.1},
            "out": {"w": rng.uniform(-0.3, 0.3, (d, d)),
                    "b": np.zeros(d)},
            "fsmn": {"taps": rng.uniform(-0.3, 0.3, (11, d))}}
    tree = {k: {n: v.astype(np.float32) for n, v in p.items()}
            for k, p in tree.items()}
    x = rng.standard_normal((2, t_len, d)).astype(np.float32)
    mask = (np.arange(t_len)[None] < np.array([[40], [23]])).astype(
        np.float32)
    mod = tlayers.SanmAttention(d, d, heads, 11, device="cpu")
    mod.load_state_dict(tzoo.params_from_jax(tree))
    xb = t(x).to(torch.bfloat16)
    outs = {}
    for env in sorted({bf16_scores, "0"}):
        monkeypatch.setenv("ASR2PASS_BF16_SCORES", env)
        ref = jlayers.sanm_attention(
            jcast_floats(tree, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
            heads, mask=jnp.asarray(mask))
        with torch.no_grad():
            got = tlayers.sanm_attention(cast_floats(mod, torch.bfloat16),
                                         xb, heads, mask=t(mask))
        ref = np.asarray(ref.astype(jnp.float32))
        # bf16 outputs summed in another order: one bf16 step of the range
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())
        outs[env] = got.float()
    if bf16_scores == "1":
        assert not torch.equal(outs["0"], outs["1"])
