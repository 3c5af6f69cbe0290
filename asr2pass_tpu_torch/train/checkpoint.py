"""Training checkpoints in the JAX package's files, so that a run saved by
either package resumes in the other.

Counterpart of the JAX package's train/checkpoint.py. A checkpoint is a
directory of:
  params.npz     the parameters in the model-directory layout (stacked
                 layer axes, runtime/model_zoo.params_to_jax);
  opt_state.npz  optax.adamw's state as `leaf_%05d` keys in
                 jax.tree.leaves order of (ScaleByAdamState(count, mu,
                 nu), EmptyState, EmptyState): count (int32), then mu's
                 leaves, then nu's, each in the sorted-key order of the
                 stacked tree (1 + 2 x 59 = 119 leaves on paraformer_tiny);
  meta.json      {"step": N, ...extra}.
torch.optim.AdamW keeps the same numbers per parameter: count is its
`step`, mu its `exp_avg`, nu its `exp_avg_sq`.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import numpy as np
import torch

from asr2pass_tpu_torch.runtime.model_zoo import (load_params,
                                                  params_from_jax,
                                                  params_to_jax, save_params)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list tree in jax.tree.leaves order:
    dict entries by sorted key, list entries in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """The inverse of tree_leaves on template's structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _moments(model, optimizer, key: str) -> dict:
    """{name: the AdamW moment `key` of that parameter (zeros before the
    first step, as optax's init)}."""
    out = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        out[name] = state[key] if key in state else torch.zeros_like(p)
    return out


def save_checkpoint(path: str, model, optimizer, step: int,
                    extra: Optional[dict] = None) -> None:
    """Write params.npz, opt_state.npz and meta.json under `path`."""
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "params.npz"), params_to_jax(model))
    counts = {int(s["step"]) for s in optimizer.state.values()
              if "step" in s}
    if len(counts) > 1:
        raise ValueError(f"parameters at different steps {sorted(counts)}: "
                         "optax keeps one count")
    leaves = [np.asarray(counts.pop() if counts else 0, np.int32)]
    for key in ("exp_avg", "exp_avg_sq"):
        leaves += tree_leaves(params_to_jax(_moments(model, optimizer, key)))
    save_params(os.path.join(path, "opt_state.npz"),
                {f"leaf_{i:05d}": x for i, x in enumerate(leaves)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), **(extra or {})}, f)


def restore_checkpoint(path: str, model, optimizer=None) -> int:
    """Load params.npz into `model` (in place) and, when `optimizer` is
    given and the checkpoint has it, the AdamW state; return the step.
    Raises if the optimizer state does not fit the model's parameters."""
    model.load_state_dict(params_from_jax(
        load_params(os.path.join(path, "params.npz"))))
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    opt_path = os.path.join(path, "opt_state.npz")
    if optimizer is None or not os.path.exists(opt_path):
        return step
    with np.load(opt_path) as data:
        leaves = [data[k] for k in sorted(data.files)]
    params = dict(model.named_parameters())
    template = params_to_jax(params)
    n = len(tree_leaves(template))
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"opt_state.npz has {len(leaves)} leaves; a model "
                         f"of {n} parameter leaves needs {1 + 2 * n}")
    count = float(leaves[0])
    mu = params_from_jax(tree_unflatten(template, leaves[1:1 + n]))
    nu = params_from_jax(tree_unflatten(template, leaves[1 + n:]))
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    return step
