"""The port's fine-tune step and checkpoints against the JAX package on
the CPU: loss_fn's loss, metrics and every gradient against
jax.value_and_grad, AdamW steps against optax.adamw's, checkpoints
resumed across the two packages both ways, and the CUDA attention entry
points' refusal to run under autograd."""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.train import checkpoint as jckpt
from asr2pass_tpu.train import train as jtrain
from asr2pass_tpu_torch.ops import attention as tatt
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from asr2pass_tpu_torch.train import checkpoint as tckpt
from asr2pass_tpu_torch.train import train as ttrain
from torch_parity import jax_params, port_model, t, tiny_cfgs

# the loss and the gradients are fp32 sums in other orders than XLA's:
# each gradient leaf within GRAD_TOL of its largest entry (1.4e-6 seen)
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
# optax.adamw and torch's AdamW on the same gradients: the same formula in
# another order of fp32 operations
OPTIMIZER_TOL = 1e-5
LR = 1e-4                    # make_optimizer's default in both packages
# Adam divides each gradient by its own root mean square, so an entry
# whose gradient is within fp32 noise of zero moves by anything up to lr:
# a step from equal parameters on gradients equal to GRAD_TOL leaves the
# parameters within half of lr of JAX's (1.0e-5 and 1.9e-5 seen), where
# a step without the restored AdamW state misses by up to 1.7e-4
STEP_TOL = 0.5 * LR
STEPS = 5


def _batch(jcfg, seed):
    """B=2 ragged: T 40 and 31 LFR frames, U 8 and 6 targets."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 40, 560)).astype(np.float32)
    arrays = (feats, np.array([40, 31], np.int32),
              rng.integers(4, jcfg.vocab_size, (2, 8)).astype(np.int32),
              np.array([8, 6], np.int32))
    jb = jtrain.TrainBatch(*(jnp.asarray(a) for a in arrays))
    tb = ttrain.TrainBatch(*(t(a) if a.dtype == np.float32
                             else torch.as_tensor(a).long() for a in arrays))
    return jb, tb


def _flat(tree):
    out = {}
    tzoo._flatten(jax.tree.map(np.asarray, tree), "", out)
    return out


def _port_flat(tensors):
    """{name: tensor} of the port -> the JAX layout, flattened."""
    return _flat(tzoo.params_to_jax(tensors))


def _assert_trees_close(got, ref, tol, what):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[k] - r).max())
        assert err <= tol * scale, (what, k, err, scale)


@pytest.fixture(scope="module", params=["plain", "timestamp_hotword"])
def setup(request):
    ts = request.param != "plain"
    jcfg, tcfg = tiny_cfgs(timestamp=ts, hotword=ts)
    return jcfg, tcfg, jax_params(jcfg, 0)


def test_loss_and_gradients_match_jax(setup):
    """Loss, ce, quantity and acc, and the gradient of every parameter;
    with the timestamp head and the hotword block, whose leaves are
    outside the loss, those gradients are zero in both."""
    jcfg, tcfg, tree = setup
    jb, tb = _batch(jcfg, 1)
    (jloss, jm), jgrads = jax.value_and_grad(
        jtrain.loss_fn, has_aux=True)(tree, jcfg, jb)
    model = port_model(tree, tcfg)
    ttrain.make_optimizer(model)
    loss, m = ttrain.loss_fn(model, tcfg, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "quantity", "acc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    ref = _flat(jgrads)
    got = _port_flat(grads)
    _assert_trees_close(got, ref, GRAD_TOL, "grad")
    zero = [k for k, g in ref.items() if not np.abs(g).any()]
    assert all(not np.abs(got[k]).any() for k in zero)
    if jcfg.use_hotword:
        assert any(k.startswith("predictor/us_cnn") for k in zero)
        assert any(k.startswith("decoder/hotword") for k in zero)


def _jax_step(jcfg, optimizer):
    """JAX's train_step, eager: under jit XLA fuses the scaled-alpha CIF
    differently, and the utterance's last fire, which the rescaled alphas
    reach exactly at the threshold, can go the other way (a 0.2 % loss
    difference); op by op, the loss equals the port's to the bit."""
    return lambda p, o, b: jtrain.train_step(p, o, b, jcfg, optimizer)


def _seeded_grads(tree, seed):
    """Gradients of the tree's shapes from a seed, over six decades of
    magnitude, with the first leaf all zero (a leaf outside the loss)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 10.0
                                  ** rng.uniform(-8, -2, a.shape)
                                  ).astype(np.float32), tree)
    first = jax.tree_util.tree_leaves_with_path(out)[0][0]
    leaf = out
    for k in first[:-1]:
        leaf = leaf[k.key]
    leaf[first[-1].key] = np.zeros_like(leaf[first[-1].key])
    return out


def test_adamw_matches_optax(setup):
    """make_optimizer's AdamW against JAX's optax.adamw, STEPS steps from
    the same parameters on the same seeded gradients: every parameter
    within OPTIMIZER_TOL, and a zero-gradient leaf decayed as optax
    decays it."""
    import optax

    jcfg, tcfg, tree = setup
    optimizer = jtrain.make_optimizer()
    params, state = tree, optimizer.init(tree)
    model = port_model(tree, tcfg)
    opt = ttrain.make_optimizer(model)
    named = dict(model.named_parameters())
    for i in range(STEPS):
        grads = _seeded_grads(tree, i)
        updates, state = optimizer.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        gsd = tzoo.params_from_jax(grads)
        for name, p in named.items():
            p.grad = gsd[name].clone()
        opt.step()
    ref = _flat(params)
    got = _port_flat(named)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=OPTIMIZER_TOL, err_msg=k)
    zero = jax.tree_util.tree_leaves_with_path(tree)[0][0]
    k = "/".join(p.key for p in zero)
    np.testing.assert_allclose(
        got[k], _flat(tree)[k] * (1 - LR * 0.01) ** STEPS, rtol=1e-6)


def test_train_step_matches_jax(setup):
    """One train_step from JAX's parameters: the loss equal to JAX's, and
    the parameters within STEP_TOL of JAX's step; the leaves outside the
    loss decayed exactly as optax decays them."""
    jcfg, tcfg, tree = setup
    jb, tb = _batch(jcfg, 1)
    optimizer = jtrain.make_optimizer()
    params, _, jm = _jax_step(jcfg, optimizer)(tree, optimizer.init(tree),
                                               jb)
    model = port_model(tree, tcfg)
    m = ttrain.train_step(model, ttrain.make_optimizer(model), tb, tcfg)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    ref = _flat(params)
    got = _port_flat(dict(model.named_parameters()))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=STEP_TOL,
                                   err_msg=k)
    if jcfg.use_hotword:
        for k in ("predictor/us_out/w", "decoder/hotword/bias_out/w"):
            if k in ref:
                np.testing.assert_allclose(
                    got[k], _flat(tree)[k] * (1 - LR * 0.01), rtol=1e-6)
                np.testing.assert_allclose(ref[k], got[k], rtol=1e-6)


def test_checkpoint_layout_is_optax(setup, tmp_path):
    """After one step the port's opt_state.npz holds JAX's leaves: the
    same count, then mu's and nu's leaves in the same order (119 on
    paraformer_tiny), each leaf within 2 x GRAD_TOL of its largest entry
    in optax's own (the moments of gradients equal to GRAD_TOL)."""
    jcfg, tcfg, tree = setup
    jb, tb = _batch(jcfg, 1)
    optimizer = jtrain.make_optimizer()
    params, opt_state, _ = _jax_step(jcfg, optimizer)(
        tree, optimizer.init(tree), jb)
    jckpt.save_checkpoint(str(tmp_path / "jax"), params, opt_state, step=1)
    model = port_model(tree, tcfg)
    opt = ttrain.make_optimizer(model)
    ttrain.train_step(model, opt, tb, tcfg)
    tckpt.save_checkpoint(str(tmp_path / "port"), model, opt, step=1,
                          extra={"lr": 1e-4})
    with np.load(tmp_path / "jax" / "opt_state.npz") as jf, \
            np.load(tmp_path / "port" / "opt_state.npz") as tf:
        assert jf.files == tf.files
        if not jcfg.use_hotword:
            assert len(tf.files) == 1 + 2 * 59
        assert tf["leaf_00000"].dtype == np.int32
        assert int(tf["leaf_00000"]) == int(jf["leaf_00000"]) == 1
        for k in jf.files[1:]:
            # mu is linear in the gradients, nu quadratic: within GRAD_TOL
            # and twice it of each leaf's largest entry
            assert jf[k].shape == tf[k].shape, k
            scale = max(float(np.abs(jf[k]).max()), 1e-30)
            assert np.abs(tf[k] - jf[k]).max() <= 2 * GRAD_TOL * scale, k
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == {"step": 1, "lr": 1e-4}


def _port_state_from_optax(tree, opt_state, tcfg):
    """The port's model and AdamW holding JAX's parameters and optax
    state, handed over in memory by optax's field names (not by the
    checkpoint's leaf order)."""
    model = port_model(jax.tree.map(np.asarray, tree), tcfg)
    opt = ttrain.make_optimizer(model)
    adam = opt_state[0]
    mu = tzoo.params_from_jax(jax.tree.map(np.asarray, adam.mu))
    nu = tzoo.params_from_jax(jax.tree.map(np.asarray, adam.nu))
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return model, opt


def _optax_state_from_port(model, opt):
    """JAX's parameters and optax.adamw state holding the port's, handed
    over in memory by field names."""
    import optax

    named = dict(model.named_parameters())
    moments = [tzoo.params_to_jax({n: opt.state[p][k]
                                   for n, p in named.items()})
               for k in ("exp_avg", "exp_avg_sq")]
    count = {int(s["step"]) for s in opt.state.values()}.pop()
    return tzoo.params_to_jax(named), (
        optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                               mu=moments[0], nu=moments[1]),
        optax.EmptyState(), optax.EmptyState())


def _same(a, b):
    a, b = _flat(a), _flat(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port"])
def test_checkpoint_resumes(setup, tmp_path, direction):
    """Step 1 in one package, save, restore in the other (or the same),
    step 2. The restored parameters and AdamW state equal what was saved
    to the bit, and step 2 from the files equals step 2 from the saver's
    state handed over in memory by optax's field names (the loss within
    1e-6, as tests/test_checkpoint.py asks, the parameters equal). Within
    the port that is the uninterrupted run's step 2.

    Across the packages the loss of one set of parameters can differ by
    the utterance's last CIF fire, which the rescaled alphas reach exactly
    at the threshold (0.05 % here), so each package's step 2 is held to
    its own; test_loss_and_gradients_match_jax and
    test_adamw_matches_optax hold the arithmetic across them."""
    jcfg, tcfg, tree = setup
    b1, b2 = _batch(jcfg, 1), _batch(jcfg, 2)
    optimizer = jtrain.make_optimizer()
    jstep = _jax_step(jcfg, optimizer)
    ck = str(tmp_path / "ck")
    if direction == "jax_to_port":
        p1, o1, _ = jstep(tree, optimizer.init(tree), b1[0])
        jckpt.save_checkpoint(ck, p1, o1, step=1)
        ref_model, ref_opt = _port_state_from_optax(p1, o1, tcfg)
        model = port_model(jax_params(jcfg, 5), tcfg)   # overwritten
        opt = ttrain.make_optimizer(model)
        assert tckpt.restore_checkpoint(ck, model, opt) == 1
        _same(_optax_state_from_port(model, opt),
              _optax_state_from_port(ref_model, ref_opt))
        ref_loss = float(ttrain.train_step(ref_model, ref_opt, b2[1],
                                           tcfg)["loss"])
        got_loss = float(ttrain.train_step(model, opt, b2[1], tcfg)["loss"])
        ref_params = _port_flat(dict(ref_model.named_parameters()))
        got_params = _port_flat(dict(model.named_parameters()))
        # control: the same step without the restored AdamW state misses
        fresh = port_model(jax_params(jcfg, 5), tcfg)
        fresh_opt = ttrain.make_optimizer(fresh)
        tckpt.restore_checkpoint(ck, fresh)
        ttrain.train_step(fresh, fresh_opt, b2[1], tcfg)
        fresh = _port_flat(dict(fresh.named_parameters()))
        assert max(np.abs(fresh[k] - ref_params[k]).max()
                   for k in ref_params) > STEP_TOL
    else:
        model = port_model(tree, tcfg)
        opt = ttrain.make_optimizer(model)
        ttrain.train_step(model, opt, b1[1], tcfg)
        tckpt.save_checkpoint(ck, model, opt, step=1)
        if direction == "port_to_jax":
            hand = _optax_state_from_port(model, opt)
            rp, ro, rstep = jckpt.restore_checkpoint(ck, optimizer)
            assert rstep == 1
            _same((rp, ro), hand)
            p_ref, _, m_ref = jstep(*hand, b2[0])
            p_got, _, m_got = jstep(rp, ro, b2[0])
            ref_params, got_params = _flat(p_ref), _flat(p_got)
            ref_loss, got_loss = float(m_ref["loss"]), float(m_got["loss"])
        else:
            ref_loss = float(ttrain.train_step(model, opt, b2[1],
                                               tcfg)["loss"])
            ref_params = _port_flat(dict(model.named_parameters()))
            model2 = port_model(jax_params(jcfg, 5), tcfg)
            opt2 = ttrain.make_optimizer(model2)
            assert tckpt.restore_checkpoint(ck, model2, opt2) == 1
            got_loss = float(ttrain.train_step(model2, opt2, b2[1],
                                               tcfg)["loss"])
            got_params = _port_flat(dict(model2.named_parameters()))
    np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-6)
    assert got_params.keys() == ref_params.keys()
    for k in ref_params:
        np.testing.assert_array_equal(got_params[k], ref_params[k],
                                      err_msg=k)


def test_restore_refuses_a_foreign_optimizer_state(tmp_path):
    """An opt_state.npz whose leaves do not fit the model raises."""
    jcfg, tcfg = tiny_cfgs()
    model = port_model(jax_params(jcfg, 0), tcfg)
    opt = ttrain.make_optimizer(model)
    tckpt.save_checkpoint(str(tmp_path), model, opt, step=3)
    np.savez(tmp_path / "opt_state.npz", leaf_00000=np.int32(0))
    with pytest.raises(ValueError, match="needs 119"):
        tckpt.restore_checkpoint(str(tmp_path), model, opt)
    assert tckpt.restore_checkpoint(str(tmp_path), model) == 3


def test_train_step_reduces_loss():
    """tests/test_parallel.py's case in the port: five steps at lr 3e-3
    on one batch lower the loss."""
    jcfg, tcfg = tiny_cfgs()
    model = port_model(jax_params(jcfg, 0), tcfg)
    opt = ttrain.make_optimizer(model, lr=3e-3)
    _, tb = _batch(jcfg, 1)
    losses = [float(ttrain.train_step(model, opt, tb, tcfg)["loss"])
              for _ in range(5)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("needs_grad,grad_mode,raises", [
    (True, True, True), (True, False, False), (False, True, False)])
def test_refuse_autograd(needs_grad, grad_mode, raises):
    """The check the CUDA entry points make before a launch: it raises
    when autograd is on and an operand needs a gradient, and only then."""
    q = torch.zeros(1, 4, 8, requires_grad=needs_grad)
    kv = torch.zeros(1, 4, 16)
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(RuntimeError, match="no backward"):
                tatt.refuse_autograd("mh_flash_attention", q, kv)
        else:
            tatt.refuse_autograd("mh_flash_attention", q, kv)


@pytest.mark.parametrize("fn", tatt.KERNEL_ENTRY_POINTS,
                         ids=lambda f: f.__name__)
def test_entry_points_check_before_launch(fn):
    """Each CUDA entry point makes the check before its launch (CPU
    tensors never reach it; tests/test_torch_cuda.py raises it on the
    card)."""
    src = inspect.getsource(fn)
    assert src.index("refuse_autograd(") < src.index("_count(")
