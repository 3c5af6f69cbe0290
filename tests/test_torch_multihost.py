"""Multi-process start-up and the sharded training step of the port, on
the CPU: init_distributed from COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID at 2 processes with local_batch_slice and make_global_mesh
(tests/test_multihost.py's start-up), and make_sharded_train_step at
dp 2 x tp 2 against the port's train_step and JAX's train_step on the
whole batch, whose target lengths differ across the dp halves. Ranks are
spawned processes (tests/torch_parallel_workers.py) in gloo groups.

The step's CIF fires on alphas rescaled to sum to each target length,
so its last fire sits on the threshold, and sums taken in another order
(the row-parallel partial sums) flip it either way (ROADMAP, "The
training loss's last CIF fire sits on the threshold"). As phase 11b of
chip_smoke.py does for card against CPU, the three steps compared here
run with the threshold THRESHOLD_SHIFT lower, which puts every fire
clear of the rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import paraformer as jparaformer
from asr2pass_tpu.train import train as jtrain
from asr2pass_tpu_torch.parallel.multihost import (init_distributed,
                                                   local_batch_slice)
from asr2pass_tpu_torch.runtime import model_zoo as tzoo
from torch_parallel_workers import spawn

STEPS = 2
# the sharded step against the whole-batch step: losses within LOSS_RTOL
LOSS_RTOL = 1e-5
# parameters after each SGD step: within PARAM_TOL of each leaf's range,
# floored at UPDATE_FLOOR of the largest update of any leaf (the key
# biases start at 0 and their true gradient is 0: their values are
# rounding)
PARAM_TOL = 1e-5
UPDATE_FLOOR = 1e-3
SGD_LR = 1e-2
THRESHOLD_SHIFT = 1e-4
# AdamW moves each element by at most about lr a step, whatever its
# gradient's size, so it moves an element whose gradient is rounding
# (the key biases': their true gradient is 0) by up to lr either way as
# the rounding's sign falls. The AdamW comparisons hold every element
# whose unsharded gradient reaches ROUNDING_GRAD of the largest at each
# step so far to within UPDATE_TOL of the largest update (lr a step),
# and count the elements the rule leaves out.
ADAMW_LR = 1e-4
ROUNDING_GRAD = 1e-6
UPDATE_TOL = 1e-3
ROUNDING_SHARE = 0.05

def test_init_distributed_is_a_noop_without_a_coordinator(monkeypatch):
    """One process, no COORDINATOR_ADDRESS: False, no group (the JAX
    package's init_distributed returns False the same way)."""
    import torch.distributed as dist

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert local_batch_slice(8) == slice(0, 8)


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    return spawn("multihost", tmp_path_factory.mktemp("mh"), 2, {},
                 {"global_batch": 8})


def test_init_distributed_from_env(two_procs):
    """Each process joins from the three variables: world 2, its rank,
    gloo on the CPU."""
    for rank, o in enumerate(two_procs):
        j = o["json"]
        assert (j["world"], j["rank"], j["backend"]) == (2, rank, "gloo")


def test_local_batch_slice_two_processes(two_procs):
    """Process r owns rows [4r, 4r + 4) of a global batch of 8."""
    assert [o["json"]["slice"] for o in two_procs] == [[0, 4], [4, 8]]


def test_global_mesh_keeps_tp_in_a_host(two_procs):
    """make_global_mesh(tp=2) over 2 processes: a (1, 2) ("dp", "tp")
    mesh, tp over consecutive ranks."""
    for rank, o in enumerate(two_procs):
        j = o["json"]
        assert j["mesh"] == [1, 2] and j["names"] == ["dp", "tp"]
        assert j["tp_rank"] == rank


# ---------------------------------------------------------------------------
# the sharded training step (dp 2 x tp 2)
# ---------------------------------------------------------------------------

def _jcfg(threshold):
    d = 32
    return jconfig.ParaformerConfig(
        encoder=jconfig.EncoderConfig(input_size=560, output_size=d,
                                      num_blocks=2, attention_heads=2,
                                      linear_units=4 * d),
        decoder=jconfig.DecoderConfig(num_blocks=2, attention_heads=2,
                                      linear_units=4 * d),
        predictor=jconfig.PredictorConfig(idim=d, threshold=threshold),
        vocab_size=64)


def _flat(tree):
    out = {}
    tzoo._flatten(jax.tree.map(np.asarray, tree), "", out)
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import optax

    threshold = jconfig.PredictorConfig().threshold - THRESHOLD_SHIFT
    cfg = _jcfg(threshold)
    tree = jax.tree.map(np.asarray,
                        jparaformer.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(4)
    # rows 0-1 go to dp rank 0 (14 target tokens), rows 2-3 to rank 1 (10)
    arrays = (rng.standard_normal((4, 40, 560)).astype(np.float32),
              np.array([40, 31, 36, 22], np.int32),
              rng.integers(4, 64, (4, 8)).astype(np.int32),
              np.array([8, 6, 3, 7], np.int32))
    inputs = {f"w/model/{k}": v.numpy()
              for k, v in tzoo.params_from_jax(tree).items()}
    inputs.update(zip(("feats", "feat_lens", "targets", "target_lens"),
                      arrays))
    outs = spawn("train", tmp_path_factory.mktemp("train"), 4, inputs,
                 {"tp": 2, "steps": STEPS, "threshold": threshold,
                  "sgd_lr": SGD_LR})
    # JAX's train_step on the whole batch, op by op (under jit XLA fuses
    # the scaled-alpha CIF differently: tests/test_torch_train.py)
    batch = jtrain.TrainBatch(*(jnp.asarray(a) for a in arrays))
    jax_steps = {}
    for kind, optimizer in (("adamw", jtrain.make_optimizer()),
                            ("sgd", optax.sgd(SGD_LR))):
        params, state = tree, optimizer.init(tree)
        jax_steps[kind] = []
        for _ in range(STEPS):
            params, state, m = jtrain.train_step(params, state, batch, cfg,
                                                 optimizer)
            jax_steps[kind].append((float(m["loss"]), _flat(params)))
    return dict(outs=outs, jax=jax_steps, init=_flat(tree))


def _step_params(o, kind, i, which):
    import torch

    pre = f"{kind}/step{i}/{which}/"
    sd = {k[len(pre):]: torch.from_numpy(o[k]) for k in o
          if k.startswith(pre)}
    return _flat(tzoo.params_to_jax(sd))


def _updates_close(got, ref, init):
    """got and ref: parameters after the same steps from `init`."""
    assert got.keys() == ref.keys() == init.keys()
    floor = UPDATE_FLOOR * max(np.abs(ref[k] - init[k]).max() for k in ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), floor)
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= PARAM_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_step_loss_matches_whole_batch(trained, step, kind):
    """Every rank reports the whole batch's loss: the port's unsharded
    train_step's and JAX's, within LOSS_RTOL (the second step's after
    the first's update)."""
    want = trained["jax"][kind][step][0]
    for o in trained["outs"]:
        loss = o["json"][kind]["loss"][step]
        np.testing.assert_allclose(loss, o["json"][kind]["whole_loss"][step],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_sgd_step_params_match_unsharded(trained, step):
    """The parameters gathered from the tp shards after each SGD step:
    the unsharded port's, on every rank. (SGD moves each parameter by its
    gradient: AdamW moves one whose gradient is rounding, as the key
    biases' is, by +-lr whichever sign the rounding took.)"""
    init = trained["init"]
    o0 = trained["outs"][0]
    got = _step_params(o0, "sgd", step, "sharded")
    _updates_close(got, _step_params(o0, "sgd", step, "whole"), init)
    for o in trained["outs"][1:]:
        _updates_close(_step_params(o, "sgd", step, "sharded"), got, init)


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_sgd_step_params_match_jax(trained, step):
    """Against JAX's train_step with optax.sgd on the whole batch."""
    _updates_close(_step_params(trained["outs"][0], "sgd", step, "sharded"),
                   trained["jax"]["sgd"][step][1], trained["init"])


def _adamw_close(got, ref, o, step):
    """got and ref: parameters after AdamW step `step`; each element held
    to UPDATE_TOL of the largest update but those whose unsharded
    gradient is rounding (ROUNDING_GRAD) at some step so far, which are
    at most ROUNDING_SHARE of all."""
    grads = [_step_params(o, "adamw", i, "grad") for i in range(step + 1)]
    tops = [max(float(np.abs(v).max()) for v in g.values()) for g in grads]
    limit = UPDATE_TOL * ADAMW_LR * (step + 1)
    left_out = total = 0
    for k in ref:
        held = np.ones(ref[k].shape, bool)
        for g, top in zip(grads, tops):
            held &= np.abs(g[k]) >= ROUNDING_GRAD * top
        left_out += int((~held).sum())
        total += held.size
        err = float(np.abs(got[k] - ref[k])[held].max(initial=0.0))
        assert err <= limit, (k, err, limit)
    assert left_out <= ROUNDING_SHARE * total, (left_out, total)


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_adamw_step_keeps_ranks_equal(trained, step):
    """AdamW on the shards: the gathered parameters are the same on every
    rank, every leaf has moved, and each element is the unsharded
    step's to within UPDATE_TOL of an update (_adamw_close)."""
    init = trained["init"]
    outs = trained["outs"]
    got = _step_params(outs[0], "adamw", step, "sharded")
    for o in outs[1:]:
        other = _step_params(o, "adamw", step, "sharded")
        for k in got:
            np.testing.assert_array_equal(other[k], got[k])
    _adamw_close(got, _step_params(outs[0], "adamw", step, "whole"),
                 outs[0], step)
    for k in got:
        assert np.abs(got[k] - init[k]).max() > 0


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_adamw_step_params_match_jax(trained, step):
    """Against JAX's train_step with its AdamW on the whole batch, by the
    same rule."""
    o = trained["outs"][0]
    _adamw_close(_step_params(o, "adamw", step, "sharded"),
                 trained["jax"]["adamw"][step][1], o, step)


# tp 4 over 2 heads: the loss within HEADS_LOSS_RTOL, each gradient
# norm within HEADS_GRAD_RTOL of the unsharded step's, floored at
# ROUNDING_GRAD of the largest (the key biases' gradients are rounding)
HEADS_LOSS_RTOL = 1e-4
HEADS_GRAD_RTOL = 1e-3


def test_sharded_step_over_more_ranks_than_heads(trained):
    """make_sharded_train_step at tp 4 over the model's 2 heads (every
    attention module whole on each rank, reduced over dp only): the loss
    of the unsharded train_step and of JAX's, and each parameter's
    gradient norm, gathered from the shards, the unsharded step's; the
    same on every rank."""
    outs = trained["outs"]
    js = outs[0]["json"]
    assert js["heads/whole_units"] == 2 + 2   # encoder and decoder blocks
    want = trained["jax"]["adamw"][0][0]
    for o in outs:
        got = o["json"]
        assert got["heads/loss"] == js["heads/loss"]
        np.testing.assert_allclose(got["heads/loss"],
                                   got["heads/whole_loss"],
                                   rtol=HEADS_LOSS_RTOL)
        np.testing.assert_allclose(got["heads/loss"], want,
                                   rtol=HEADS_LOSS_RTOL)
    ref = js["heads/whole_grad_norms"]
    assert js["heads/grad_norms"].keys() == ref.keys()
    floor = ROUNDING_GRAD * max(ref.values())
    for k, n in js["heads/grad_norms"].items():
        assert abs(n - ref[k]) <= HEADS_GRAD_RTOL * max(ref[k], floor), \
            (k, n, ref[k])


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_sharded_step_metrics_are_the_whole_batchs(trained, kind):
    """ce, quantity and acc are the whole batch's, equal on every rank,
    and loss = ce + quantity."""
    ms = [o["json"][kind]["metrics"][0] for o in trained["outs"]]
    for m in ms[1:]:
        assert m == ms[0]
    m = ms[0]
    np.testing.assert_allclose(m["loss"], m["ce"] + m["quantity"],
                               rtol=1e-6)
    assert 0.0 <= m["acc"] <= 1.0
