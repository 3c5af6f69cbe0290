"""The port's model modules against their JAX counterparts on the CPU, in
fp32: layers, SAN-M encoder, CIF predictor and SAN-M decoder.

Weights come from the JAX `init` of a tiny Paraformer (d=64, 2 blocks,
bicif timestamp head and hotword block) and reach the port through
`params_from_jax`; inputs are made with numpy from a seed. Tolerances
are stated per test: the two frameworks sum fp32 products in different
orders (CPU BLAS vs XLA), which moves results by a few ulps per layer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.models import cif as jcif
from asr2pass_tpu.models import layers as jl
from asr2pass_tpu.models import sanm_decoder as jdec
from asr2pass_tpu.models import sanm_encoder as jenc
from asr2pass_tpu_torch.models import cif as tcif
from asr2pass_tpu_torch.models import layers as tl
from asr2pass_tpu_torch.models import sanm_decoder as tdec
from asr2pass_tpu_torch.models import sanm_encoder as tenc
from torch_parity import jax_params, port_model, ragged_mask, t, tiny_cfgs

# one layer: fp32 products of width <= 128, summed in another order
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_cfgs(timestamp=True, hotword=True)
    tree = jax_params(jcfg, seed=0)
    return jcfg, tcfg, tree, port_model(tree, tcfg)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_dense_layer_norm_ffn(models):
    _, _, tree, model = models
    layer = model.encoder.rest[0]
    jlayer = jax_layer(tree["encoder"]["rest"], 0)
    x = _x((2, 7, 64)) * 3 + 1
    _close(tl.layer_norm(layer.ln1, t(x)),
           jl.layer_norm(jlayer["ln1"], jnp.asarray(x)))
    _close(tl.ffn(layer.ffn, t(x)), jl.ffn(jlayer["ffn"], jnp.asarray(x)))
    jp = tree["encoder"]["first"]["att"]["out"]
    _close(tl.dense(model.encoder.first.att.out, t(x)),
           jl.dense(jp, jnp.asarray(x)))


def test_layer_norm_bf16_keeps_fp32_statistics(models):
    """Under bf16 the statistics are fp32 and the result is cast back:
    one bf16 rounding of the same fp32 value in both."""
    _, _, tree, model = models
    x = (_x((2, 5, 64)) * 100 + 1000).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jl.layer_norm(tree["encoder"]["first"]["ln2"], xb)
    got = tl.layer_norm(model.encoder.first.ln2, t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(ref.astype(jnp.float32)), rtol=8e-3,
           atol=8e-3)


@pytest.mark.parametrize("start,length,depth", [(0, 300, 560), (17, 5, 64)])
def test_sinusoidal_posenc(start, length, depth):
    # sin/cos of positions up to 300 in fp32: a few ulps of the argument
    _close(tl.sinusoidal_posenc(start, length, depth),
           jl.sinusoidal_posenc(start, length, depth), rtol=0, atol=1e-4)


def test_length_mask():
    lens = np.array([0, 3, 7])
    got = tl.length_mask(torch.tensor(lens), 7)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.length_mask(
                                      jnp.asarray(lens), 7)))


@pytest.mark.parametrize("left", [None, 0, 3, 10])
def test_fsmn_apply(models, left):
    """Centred, causal and shifted windows, masked before and after."""
    _, _, tree, model = models
    x = _x((2, 40, 64))
    mask = ragged_mask([40, 23], 40)
    jp = {"taps": tree["decoder"]["blocks"]["fsmn"]["taps"][1]}
    _close(tl.fsmn_apply(model.decoder.blocks[1].fsmn, t(x), t(mask),
                         left=left),
           jl.fsmn_apply(jp, jnp.asarray(x), jnp.asarray(mask), left=left))


@pytest.mark.parametrize("t_len,att", [(40, False), (40, True),
                                       (300, False)])
def test_sanm_attention(models, t_len, att):
    """The plain branch, with and without the extra attention mask, and
    at T=300 (the shapes the kernels take on the card)."""
    _, _, tree, model = models
    x = _x((2, t_len, 64))
    mask = ragged_mask([t_len, t_len // 3], t_len)
    am = (np.tril(np.ones((t_len, t_len), np.float32)) if att else None)
    jp = jax_layer(tree["encoder"]["rest"], 0)["att"]
    got = tl.sanm_attention(model.encoder.rest[0].att, t(x), 2, t(mask),
                            None if am is None else t(am))
    ref = jl.sanm_attention(jp, jnp.asarray(x), 2, jnp.asarray(mask),
                            None if am is None else jnp.asarray(am))
    _close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lens", [[30, 11], [30, 0]])
def test_cross_attention(models, lens):
    """Padded query rows are not zeroed; a length-0 memory row (a
    batch-bucket padding row) stays finite and equal."""
    _, _, tree, model = models
    x, mem = _x((2, 9, 64)), _x((2, 30, 64), seed=2)
    mask = ragged_mask(lens, 30)
    jp = jax_layer(tree["decoder"]["blocks"], 0)["cross"]
    got = tl.cross_attention(model.decoder.blocks[0].cross, t(x), t(mem), 2,
                             t(mask))
    assert torch.isfinite(got).all()
    _close(got, jl.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), 2,
                                   jnp.asarray(mask)), rtol=1e-4, atol=1e-5)


def test_lstm_apply(models):
    _, _, tree, model = models
    xs = _x((2, 25, 64))
    _close(tl.lstm_apply(model.predictor.blstm["bw"], t(xs)),
           jl.lstm_apply(tree["predictor"]["blstm"]["bw"], jnp.asarray(xs)))


def jax_layer(stack, i):
    """Layer i of a stacked JAX subtree."""
    if isinstance(stack, dict):
        return {k: jax_layer(v, i) for k, v in stack.items()}
    return stack[i]


@pytest.mark.parametrize("t_len,lens", [(300, [300, 211]), (64, [64, 0])])
def test_encoder(models, t_len, lens):
    """Full encoder at T=300 and with a length-0 row. Two blocks of
    width 64 after input scaling by sqrt(d): rtol 1e-4."""
    jcfg, _, tree, model = models
    feats = _x((2, t_len, 560))
    mask = ragged_mask(lens, t_len)
    got = tenc.apply(model.encoder, t(feats), t(mask), d_model=64, heads=2)
    ref = jenc.apply(tree["encoder"], jnp.asarray(feats), jnp.asarray(mask),
                     d_model=64, heads=2)
    assert torch.isfinite(got).all()
    _close(got, ref, rtol=1e-4, atol=1e-4)


def test_alphas_and_upsampled_alphas(models):
    jcfg, tcfg, tree, model = models
    enc = _x((2, 50, 64))
    mask = ragged_mask([50, 31], 50)
    _close(tcif.alphas_head(model.predictor, t(enc), tcfg.predictor,
                            t(mask)),
           jcif.alphas_head(tree["predictor"], jnp.asarray(enc),
                            jcfg.predictor, jnp.asarray(mask)))
    tok = np.array([7, 4])
    # a 150-step BLSTM: errors grow through the recurrence
    _close(tcif.upsampled_alphas(model.predictor, t(enc), tcfg.predictor,
                                 t(mask), token_num=torch.tensor(tok)),
           jcif.upsampled_alphas(tree["predictor"], jnp.asarray(enc),
                                 jcfg.predictor, jnp.asarray(mask),
                                 token_num=jnp.asarray(tok)),
           rtol=1e-4, atol=1e-5)


def _alphas(seed, b=3, t_len=60, scale=0.6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, scale, (b, t_len)).astype(np.float32),
            rng.standard_normal((b, t_len, 16)).astype(np.float32))


@pytest.mark.parametrize("max_tokens", [None, 40, 5])
def test_fire_is_exact(max_tokens):
    """Identical alphas give identical fires, counts and packed frames,
    including fires past max_tokens sent to the guard slot (5)."""
    alphas, hidden = _alphas(3)
    jf, jc, jfi, js = jcif.fire(jnp.asarray(hidden), jnp.asarray(alphas),
                                1.0, max_tokens=max_tokens)
    tf, tc, tfi, ts = tcif.fire(t(hidden), t(alphas), 1.0,
                                max_tokens=max_tokens)
    np.testing.assert_array_equal(tfi.numpy(), np.asarray(jfi))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.integrate.numpy(),
                                  np.asarray(js.integrate))
    np.testing.assert_array_equal(ts.frame.numpy(), np.asarray(js.frame))
    if max_tokens == 5:
        assert (tc.numpy() == 5).all()


@pytest.mark.parametrize("lengths", [None, [60, 33, 0]])
def test_fire_offline_is_exact(lengths):
    """Tail alpha at each row's first padding position, hidden zeroed
    from there; a length-0 row fires only the tail."""
    alphas, hidden = _alphas(4)
    if lengths is not None:
        alphas = alphas * ragged_mask(lengths, 60)
    kw = {} if lengths is None else {"lengths": np.asarray(lengths)}
    jf, jc, jfi = jcif.fire_offline(
        jnp.asarray(hidden), jnp.asarray(alphas), 1.0, 0.45, max_tokens=38,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tf, tc, tfi = tcif.fire_offline(
        t(hidden), t(alphas), 1.0, 0.45, max_tokens=38,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(tfi.numpy(), np.asarray(jfi))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_peaks_from_alphas_is_exact():
    alphas, _ = _alphas(5, t_len=90)
    np.testing.assert_array_equal(
        tcif.peaks_from_alphas(t(alphas), 1.0 - 1e-4).numpy(),
        np.asarray(jcif.peaks_from_alphas(jnp.asarray(alphas), 1.0 - 1e-4)))


@pytest.mark.parametrize("hotword", [False, True])
@pytest.mark.parametrize("sanm_shift", [None, 0])
def test_decoder(models, hotword, sanm_shift):
    """Offline decoder with and without hotword embeddings, causal and
    centred FSMN windows; a length-0 token row included."""
    import dataclasses

    jcfg, tcfg, tree, model = models
    jd = dataclasses.replace(jcfg.decoder, sanm_shift=sanm_shift)
    td = dataclasses.replace(tcfg.decoder, sanm_shift=sanm_shift)
    ac, enc = _x((3, 12, 64)), _x((3, 40, 64), seed=2)
    enc_mask = ragged_mask([40, 25, 0], 40)
    tok_mask = ragged_mask([12, 7, 0], 12)
    hw = hw_mask = None
    if hotword:
        hw, hw_mask = _x((3, 5, 64), seed=3), ragged_mask([5, 2, 0], 5)
    got = tdec.apply(model.decoder, t(ac), t(enc), t(enc_mask), t(tok_mask),
                     None if hw is None else t(hw),
                     None if hw is None else t(hw_mask), cfg=td)
    ref = jdec.apply(tree["decoder"], jnp.asarray(ac), jnp.asarray(enc),
                     jnp.asarray(enc_mask), jnp.asarray(tok_mask),
                     None if hw is None else jnp.asarray(hw),
                     None if hw is None else jnp.asarray(hw_mask), cfg=jd)
    assert torch.isfinite(got).all()
    _close(got, ref, rtol=1e-4, atol=1e-4)
