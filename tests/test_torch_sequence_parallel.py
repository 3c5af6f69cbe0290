"""The port's sequence-parallel encoder and recognizer against the JAX
package on the CPU: tests/test_sequence_parallel.py's shapes at sp 2 and
4, whole and with right padding, against JAX's encode_sequence_parallel
on a mesh of as many devices and against the unsharded encoders; the
recognizer routing a 12 s segment past sp_threshold=64 gives JAX's text.
The port runs in 4 gloo ranks (sp 2 as a 2 x 2 mesh's inner axis, sp 4
over all), one spawn for the module."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.models import sanm_encoder as jenc
from asr2pass_tpu.models.layers import length_mask as jlength_mask
from asr2pass_tpu.parallel.sequence import encode_sequence_parallel
from asr2pass_tpu.runtime.offline_asr import ParaformerOffline as JOffline
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from torch_parallel_workers import spawn

WORLD = 4
SPS = [2, 4]
# encodings against JAX's SP and the unsharded encoders: within 1e-4 of
# the reference's range (the same sums; the all-gathered attention and
# the halo conv add in the same order, XLA's fusions in another)
RANGE_TOL = 1e-4
# tests/test_sequence_parallel.py's two encoders: whole and padded
ENCODERS = [{"name": "whole", "blocks": 3, "seed": 0, "b": 2, "t": 64},
            {"name": "padded", "blocks": 2, "seed": 1, "b": 1, "t": 64,
             "valid": 50}]


def _ecfg(blocks):
    return jconfig.EncoderConfig(input_size=560, output_size=32,
                                 num_blocks=blocks, attention_heads=2,
                                 linear_units=64)


def _within_range(got, ref, tol=RANGE_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    inputs, jax_ref = {}, {}
    for c in ENCODERS:
        cfg = _ecfg(c["blocks"])
        tree = jax.tree.map(np.asarray,
                            jenc.init(jax.random.PRNGKey(c["seed"]), cfg))
        for k, v in params_from_jax({"encoder": tree}).items():
            inputs[f"w/{c['name']}/{k.removeprefix('encoder.')}"] = v.numpy()
        rng = np.random.default_rng(c["seed"])
        feats = rng.standard_normal((c["b"], c["t"], 560)).astype(np.float32)
        valid = c.get("valid")
        mask, lengths = None, None
        if valid is not None:
            feats[:, valid:] = 0.0
            lengths = [valid] * c["b"]
            mask = jlength_mask(np.asarray(lengths), c["t"])
        inputs[f"{c['name']}/feats"] = feats
        jax_ref[c["name"]] = {"whole": np.asarray(jenc.apply(
            tree, feats, mask, d_model=32, heads=2))}
        for n in SPS:
            mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
            jax_ref[c["name"]][n] = np.asarray(encode_sequence_parallel(
                tree, feats, cfg, mesh, axis="sp", lengths=lengths))
    pcfg = jconfig.paraformer_tiny()
    ptree = jax.tree.map(np.asarray,
                         jparaformer.init(jax.random.PRNGKey(0), pcfg))
    for k, v in params_from_jax(ptree).items():
        inputs[f"w/tiny/{k}"] = v.numpy()
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal(16000 * 12) * 0.1).astype(np.float32)
    inputs["wave"] = wave
    vocab = make_test_vocab(pcfg.vocab_size)
    texts = {"whole": JOffline(ptree, pcfg, vocab).recognize(wave)}
    for n in SPS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
        texts[n] = JOffline(ptree, pcfg, vocab, sp_mesh=mesh,
                            sp_threshold=64).recognize(wave)
    outs = spawn("sequence", tmp_path_factory.mktemp("sp"), WORLD, inputs,
                 {"encoders": ENCODERS})
    return dict(outs=outs, jax=jax_ref, texts=texts)


def _valid(c):
    return slice(None, c.get("valid"))


@pytest.mark.parametrize("n", SPS)
@pytest.mark.parametrize("c", ENCODERS, ids=[c["name"] for c in ENCODERS])
def test_sp_encoder_matches_jax_sp(sp, c, n):
    """Every rank's whole output against JAX's encode_sequence_parallel
    at the same sp (valid frames; JAX's padded frames are its own)."""
    ref = sp["jax"][c["name"]][n]
    v = _valid(c)
    for o in sp["outs"]:
        _within_range(o[f"{c['name']}/sp{n}"][:, v], ref[:, v])


@pytest.mark.parametrize("n", SPS)
@pytest.mark.parametrize("c", ENCODERS, ids=[c["name"] for c in ENCODERS])
def test_sp_encoder_matches_unsharded(sp, c, n):
    """Against the port's and JAX's unsharded (masked) encoders on the
    valid frames."""
    v = _valid(c)
    o = sp["outs"][0]
    _within_range(o[f"{c['name']}/sp{n}"][:, v], o[f"{c['name']}/whole"][:, v])
    _within_range(o[f"{c['name']}/sp{n}"][:, v],
                  sp["jax"][c["name"]]["whole"][:, v])


@pytest.mark.parametrize("n", SPS)
def test_sp_collectives_per_block(sp, n):
    """Each block all-gathers k and v and exchanges one halo; the output
    is all-gathered once."""
    blocks = ENCODERS[0]["blocks"]
    assert sp["outs"][0]["json"][f"whole/sp{n}/collectives"] == {
        "all_reduce": 0, "all_gather": 2 * blocks + 1,
        "halo": blocks, "broadcast": 0}


@pytest.mark.parametrize("n", SPS)
def test_sp_recognizer_matches_jax(sp, n):
    """12 s (about 200 LFR frames) past sp_threshold=64 through the
    sequence-parallel path: JAX's SP text, which equals the unsharded
    text, on every rank."""
    want = sp["texts"][n][0]
    assert want and want == sp["texts"]["whole"][0]
    for o in sp["outs"]:
        assert o["json"][f"rec/sp{n}"][0] == want
        assert o["json"]["rec/whole"][0] == want
