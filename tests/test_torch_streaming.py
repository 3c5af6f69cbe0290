"""The port's streaming pass 1 against the JAX package on the CPU: the
cached FSMN, the streaming decoder, the CIF carry, the batched online
step, the chunk-incremental front-end and the online stream's text.

Weights come from the JAX `init` of paraformer_tiny (d=64, 2 encoder and
2 decoder blocks), carried across with `params_from_jax`; inputs are
made with numpy from a seed. Layers are held to rtol/atol 1e-5, whole
models to 1e-4; ids, counts and text must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.config import FrontendConfig as JFrontendConfig
from asr2pass_tpu.models import cif as jcif
from asr2pass_tpu.models import layers as jl
from asr2pass_tpu.models import paraformer_online as jonline
from asr2pass_tpu.models import sanm_decoder as jdec
from asr2pass_tpu.runtime.asr_stream import (
    ParaformerOnlineStream as JOnlineStream)
from asr2pass_tpu.runtime.streaming_frontend import (
    StreamingFrontend as JStreamingFrontend)
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch.config import FrontendConfig as TFrontendConfig
from asr2pass_tpu_torch.models import cif as tcif
from asr2pass_tpu_torch.models import layers as tl
from asr2pass_tpu_torch.models import paraformer_online as tonline
from asr2pass_tpu_torch.models import sanm_decoder as tdec
from asr2pass_tpu_torch.runtime.asr_stream import (
    ParaformerOnlineStream as TOnlineStream)
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.streaming_frontend import (
    StreamingFrontend as TStreamingFrontend)
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import jax_params, port_model, ragged_mask, t, tiny_cfgs

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_cfgs()
    tree = jax_params(jcfg, seed=0)
    return jcfg, tcfg, tree, port_model(tree, tcfg)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or LAYER_TOL))


@pytest.mark.parametrize("valid_len", [None, [9, 4]])
def test_fsmn_apply_cached(models, valid_len):
    """Output and the next cache; with valid_len the cache advances by
    exactly that many frames of a padded chunk."""
    _, _, tree, model = models
    x, cache = _x((2, 9, 64)), _x((2, 10, 64), seed=2)
    jp = {"taps": tree["decoder"]["blocks"]["fsmn"]["taps"][0]}
    vl = None if valid_len is None else np.asarray(valid_len)
    jout, jcache = jl.fsmn_apply_cached(
        jp, jnp.asarray(x), jnp.asarray(cache),
        None if vl is None else jnp.asarray(vl))
    tout, tcache = tl.fsmn_apply_cached(
        model.decoder.blocks[0].fsmn, t(x), t(cache),
        None if vl is None else torch.as_tensor(vl))
    _close(tout, jout)
    np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))


def test_apply_streaming(models):
    """Logits and the [L, B, kernel-1, D] caches over two padded chunks,
    streams with unequal token counts (one with none)."""
    _, _, tree, model = models
    jcaches = jdec.init_caches(tree["decoder"], 2)
    tcaches = tdec.init_caches(model.decoder, 2)
    assert tuple(tcaches.shape) == jcaches.shape
    for seed, counts in ((3, [6, 2]), (4, [5, 0])):
        ac, enc = _x((2, 6, 64), seed), _x((2, 20, 64), seed + 10)
        enc_mask = ragged_mask([20, 17], 20)
        tok = ragged_mask(counts, 6)
        vl = np.asarray(counts)
        jlog, jcaches = jdec.apply_streaming(
            tree["decoder"], jnp.asarray(ac), jnp.asarray(enc), jcaches,
            jnp.asarray(enc_mask), jnp.asarray(tok), jnp.asarray(vl),
            heads=2)
        tlog, tcaches = tdec.apply_streaming(
            model.decoder, t(ac), t(enc), tcaches, t(enc_mask), t(tok),
            torch.as_tensor(vl), heads=2)
        _close(tlog, jlog, **MODEL_TOL)
        _close(tcaches, jcaches, **MODEL_TOL)


def test_fire_from_nonzero_state():
    """A carried (integrate, frame) state: fires, counts, packed frames
    and the next state are bit-equal to the JAX package's."""
    rng = np.random.default_rng(5)
    alphas = rng.uniform(0, 0.6, (3, 40)).astype(np.float32)
    hidden = rng.standard_normal((3, 40, 16)).astype(np.float32)
    integ = np.array([0.7, 0.0, 0.95], np.float32)
    frame = rng.standard_normal((3, 16)).astype(np.float32)
    jf, jc, jfi, js = jcif.fire(jnp.asarray(hidden), jnp.asarray(alphas),
                                1.0, jcif.CifState(jnp.asarray(integ),
                                                   jnp.asarray(frame)))
    tf, tc, tfi, ts = tcif.fire(t(hidden), t(alphas), 1.0,
                                tcif.CifState(t(integ), t(frame)))
    assert bool(tfi[:, 0].any())        # a carried state fires at once
    for got, ref in ((tfi, jfi), (tc, jc), (tf, jf),
                     (ts.integrate, js.integrate), (ts.frame, js.frame)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_online_step(models):
    """Five chunks of two streams with unequal frame counts, the second
    stream flushed (is_final) at chunk 3 and restarted: every field of
    the state within the model tolerance, equal counts and ids."""
    jcfg, tcfg, tree, model = models
    center = jcfg.chunk_size[1]
    lfr = jcfg.frontend.lfr_dim
    jstate = jonline.init_state(tree, jcfg, 2)
    tstate = tonline.init_state(model, tcfg, 2)
    plan = [([10, 10], [False, False]), ([10, 7], [False, False]),
            ([10, 4], [False, True]), ([9, 10], [False, False]),
            ([3, 10], [True, False])]
    n_tok = 0
    for i, (counts, fin) in enumerate(plan):
        feats = _x((2, center, lfr), 20 + i) * ragged_mask(
            counts, center)[..., None]
        jstate, jids, jn = jonline.step(
            tree, jcfg, jstate, jnp.asarray(feats),
            jnp.asarray(counts, jnp.int32), jnp.asarray(fin))
        tstate, tids, tn = tonline.step(
            model, tcfg, tstate, t(feats),
            torch.tensor(counts, dtype=torch.int32), torch.tensor(fin))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for b, k in enumerate(tn.tolist()):
            np.testing.assert_array_equal(tids[b, :k].numpy(),
                                          np.asarray(jids)[b, :k])
        n_tok += int(tn.sum())
        for name in tonline.OnlineState._fields:
            got, ref = getattr(tstate, name), getattr(jstate, name)
            if name == "pos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            else:
                _close(got, ref, **MODEL_TOL)
    assert n_tok > 0


@pytest.mark.parametrize("chunks", [[16000], [800] * 20,
                                    [123, 4567, 890, 10420]])
@pytest.mark.parametrize("lfr", [(5, 1), (7, 6)])
def test_streaming_frontend(chunks, lfr):
    """LFR+CMVN rows of every accept (the VAD's 5/1 and the ASR's 7/6
    front-ends) against the JAX package's, under three chunkings."""
    m, n = lfr
    jcfg, tcfg = JFrontendConfig(lfr_m=m, lfr_n=n), TFrontendConfig(
        lfr_m=m, lfr_n=n)
    rng = np.random.default_rng(6)
    wave = (rng.standard_normal(sum(chunks)) * 0.1).astype(np.float32)
    means = rng.uniform(-12, -8, jcfg.lfr_dim).astype(np.float32)
    vars_ = rng.uniform(0.2, 0.4, jcfg.lfr_dim).astype(np.float32)
    jsf = JStreamingFrontend(jcfg, means, vars_)
    tsf = TStreamingFrontend(tcfg, means, vars_, device="cpu")
    off, rows = 0, 0
    for i, c in enumerate(chunks):
        fin = i == len(chunks) - 1
        ref = jsf.accept(wave[off: off + c], fin)
        got = tsf.accept(wave[off: off + c], fin)
        assert got.shape == ref.shape
        # fbank as fp32 products in another order: the log-mel tolerance
        # of tests/test_torch_frontend.py (CMVN scales it by <= 0.4)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        off += c
        rows += got.shape[0]
    assert rows > 0


def test_online_stream_text(models):
    """ParaformerOnlineStream.accept: the partial text of each 9600-sample
    call and of the final flush equals the JAX stream's."""
    jcfg, tcfg, tree, _ = models
    vocab = make_test_vocab(jcfg.vocab_size)
    rng = np.random.default_rng(7)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    n = 16000 * 3 + 1234
    tt = np.arange(n) / 16000
    wave = (0.2 * np.sin(2 * np.pi * 180 * tt)
            * 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
            + 0.02 * rng.standard_normal(n)).astype(np.float32)
    js = JOnlineStream(tree, jcfg, vocab, cmvn=cmvn)
    ts = TOnlineStream(params_from_jax(tree), tcfg, TVocab(vocab.tokens),
                       cmvn=cmvn, device="cpu")
    texts = []
    for off in range(0, n, 9600):
        fin = off + 9600 >= n
        ref = js.accept(wave[off: off + 9600], fin)
        got = ts.accept(wave[off: off + 9600], fin)
        assert got == ref
        texts.append(got)
    assert "".join(texts)
    # reusable after the final flush, as the JAX stream is
    assert ts.accept(wave[:16000], True) == js.accept(wave[:16000], True)
