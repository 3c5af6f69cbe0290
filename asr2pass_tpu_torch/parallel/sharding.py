"""Device mesh and Megatron-style parameter sharding (tp x dp).

Counterpart of the JAX package's parallel/sharding.py. There the rules
annotate each parameter with a PartitionSpec and GSPMD derives the
collectives; here shard_params cuts each rank's local module out of the
whole one and marks the modules that run sharded, whose functions
(models/layers.py) then issue the collectives themselves:

  column-parallel  qkv, q, kv, w1, and the vocab heads decoder/out and
                   ctc: each rank holds its columns, the input enters
                   through comm.copy_to_tp
  row-parallel     the attention out, cross/out, w2: each rank holds the
                   rows of its columns above, the partial products meet in
                   comm.reduce_from_tp, the bias is added once after it

Attention is cut by head, not by column range: rank r of tp takes heads
[r H/tp, (r+1) H/tp), so the fused qkv [Din, 3D] becomes
[q_r | k_r | v_r] and the cross kv [D, 2D] becomes [k_r | v_r], the
layout the attention kernels read in place (layers.sanm_attention). The
encoder's FSMN taps follow v's channels. The layer norms, the decoder's
FSMN, the CIF predictor and the bicif BLSTM, the embeddings and the
vocab heads' biases stay whole on every rank.

param_specs states, for every key of a state dict (the names of
model_zoo.params_from_jax, '.'- or '/'-joined), the dim the port shards
it on. Each key it shards the JAX rules shard on the same dim (tested);
the keys the JAX rules shard and the port keeps whole are the
replicated modules above, which the JAX package shards only because
GSPMD can reshard anything.

A unit (an attention, an FFN, a vocab head) stays whole on every rank,
none of its keys sliced and no tp_group set, so that models/layers.py
runs it as the unsharded layer with no collective, in two cases:
  * an attention whose heads the axis does not divide (GSPMD computes
    such an attention whole as well);
  * a unit holding an int8 Dense (w_q or w_q8): the JAX rules match only
    the float `w`, so its int8 leaves stay whole on every device.
An int8 Paraformer under TP is thus whole on every rank, as it is under
the JAX rules: TP then saves no memory, and the recognizer still splits
its rows over dp. Quantize before sharding: utils.quantize_params
refuses a shard (JAX's scales on a row-parallel shard are a max over
the whole input axis, not over the rank's rows).

gather_whole undoes shard_params for a module or a part of one (the
sequence-parallel encoder of a TP model takes whole weights).
"""
from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from asr2pass_tpu_torch.models.layers import (CrossAttention, Dense, Ffn,
                                              SanmAttention)
from asr2pass_tpu_torch.parallel.comm import all_gather, group_size, tp_group

# key suffix -> dim the port shards on
_COL_W = ("qkv/w", "kv/w", "q/w", "w1/w", "decoder/out/w", "ctc/w",
          "att/fsmn/taps")
_COL_B = ("qkv/b", "kv/b", "q/b", "w1/b")
_ROW_W = ("att/out/w", "cross/out/w", "w2/w")
# fused projections: the number of column blocks cut by head
_FUSED = {"qkv": 3, "kv": 2}
VOCAB_HEADS = ("decoder/out/w", "ctc/w")


def _path(key: str) -> str:
    return key.replace(".", "/")


def _spec(path: str) -> Optional[int]:
    if path.endswith(_COL_W):
        return 1
    if path.endswith(_COL_B):
        return 0
    if path.endswith(_ROW_W):
        return 0
    return None


def param_specs(state_dict: Mapping) -> Dict[str, Optional[int]]:
    """{key: the dim the port shards it on over tp, or None (whole on
    every rank)}, keys as given."""
    return {k: _spec(_path(k)) for k in state_dict}


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None):
    """("dp", "tp") DeviceMesh over the process group's ranks (all of
    them: n_devices, when given, must be the world size); tp over
    consecutive ranks, the inner axis. tp defaults to 2 when n is even
    and more than 1, else 1 (the JAX package's make_mesh). The mesh's
    device is the card under NCCL, else the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: {n_devices} devices "
                         f"asked, world size {n}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def _units(model: nn.Module) -> Dict[str, nn.Module]:
    """{name: module} of the units that shard as one: every attention,
    FFN and vocab head."""
    units = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (SanmAttention, CrossAttention, Ffn)) or (
                isinstance(mod, Dense)
                and _path(f"{name}.w").endswith(VOCAB_HEADS)):
            units[name] = mod
    return units


def whole_units(model: nn.Module, n: int) -> set:
    """The names of the units that stay whole over tp=n: each attention
    whose heads n does not divide, each unit holding an int8 Dense."""
    whole = set()
    for name, mod in _units(model).items():
        if any(isinstance(d, Dense) and d.weight_key != "w"
               for d in mod.modules()) or (
                isinstance(mod, (SanmAttention, CrossAttention))
                and mod.heads % n):
            whole.add(name)
    return whole


def _owner(key: str, units) -> Optional[str]:
    """The unit a parameter key belongs to."""
    mod = key.rsplit(".", 1)[0]
    while mod:
        if mod in units:
            return mod
        mod = mod.rsplit(".", 1)[0] if "." in mod else ""
    return None


def _blocks(key: str) -> int:
    return _FUSED.get(key.replace("/", ".").rsplit(".", 2)[-2], 1)


def _check(params: Mapping, sliced: Dict[str, int], n: int):
    """The widths of what is sliced must split over tp=n."""
    for key, dim in sliced.items():
        width = params[key].shape[dim]
        if width % (_blocks(key) * n):
            raise ValueError(
                f"{key} {tuple(params[key].shape)}: dim {dim} of {width} "
                f"does not split over tp={n}")


def local_slice(key: str, value, dim: int, n: int, rank: int):
    """Rank `rank`'s part of one parameter: its heads' column blocks of a
    fused qkv or kv projection, else its 1/n range of `dim`."""
    blocks = _blocks(key)
    parts = [blk.chunk(n, dim)[rank] for blk in value.chunk(blocks, dim)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim)


def gather_param(part, key: str, dim: int, group):
    """The whole parameter from each rank's `part` (local_slice's inverse):
    the parts all-gathered along `dim`, a fused projection's per-rank
    [q_r | k_r | v_r] blocks put back into [q | k | v]. A collective of
    the group."""
    n, blocks = group_size(group), _blocks(key)
    whole = all_gather(part, dim, group)
    if blocks == 1:
        return whole
    parts = whole.chunk(n * blocks, dim)
    return torch.cat([parts[r * blocks + b] for b in range(blocks)
                      for r in range(n)], dim)


def sliced_params(model: nn.Module) -> Dict[str, tuple]:
    """{parameter key: (dim, group)} of every parameter shard_params
    sliced in `model` (a shard, or a part of one)."""
    out = {}
    for name, mod in model.named_modules():
        group = tp_group(mod)
        if group is None:
            continue
        for rel, dim in getattr(mod, "tp_dims", {}).items():
            out[f"{name}.{rel}" if name else rel] = (dim, group)
    return out


def shard_params(model: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """This rank's local module: a copy of `model` holding its shards of
    the parameters param_specs names, each sliced unit marked with the
    mesh's `axis` group (comm.tp_group) and its sliced keys (tp_dims);
    the units whole_units names stay whole. Raises ValueError for a
    sliced width that the axis does not divide (a vocab head, an FFN)."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    rank = mesh.get_local_rank(axis)
    params = dict(model.named_parameters())
    units = _units(model)
    whole = whole_units(model, n)
    sliced = {key: dim for key, dim in param_specs(params).items()
              if dim is not None and _owner(key, units) not in whole}
    _check(params, sliced, n)
    local = copy.deepcopy(model)
    for key, dim in sliced.items():
        mod_name, pname = key.rsplit(".", 1)
        old = getattr(local.get_submodule(mod_name), pname)
        part = local_slice(key, old.detach(), dim, n, rank).clone()
        setattr(local.get_submodule(mod_name), pname,
                nn.Parameter(part, requires_grad=old.requires_grad))
        unit = _owner(key, units)
        mod = local.get_submodule(unit)
        mod.tp_group = group
        mod.tp_dims = {**getattr(mod, "tp_dims", {}),
                       key[len(unit) + 1:]: dim}
    local.tp_shard_group = group
    return local


def gather_whole(model: nn.Module) -> nn.Module:
    """A whole copy of a shard or of a part of one (the encoder of a TP
    model): every sliced parameter all-gathered over its unit's group
    (gather_param), no tp_group left; `model` itself where nothing in it
    is sliced. A collective of each group: every rank of the shard calls
    it. The copy is the caller's to drop."""
    sliced = sliced_params(model)
    if not sliced:
        return model
    # neither the groups nor the shards are copied: the copy's sliced
    # parameters are replaced below
    memo = {id(g): g for _, g in sliced.values()}
    params = dict(model.named_parameters())
    memo.update((id(params[k]), params[k]) for k in sliced)
    whole = copy.deepcopy(model, memo=memo)
    for key, (dim, group) in sliced.items():
        mod_name, pname = key.rsplit(".", 1)
        mod = whole.get_submodule(mod_name)
        old = getattr(mod, pname)
        setattr(mod, pname, nn.Parameter(
            gather_param(old.detach(), key, dim, group),
            requires_grad=False))
    for mod in whole.modules():
        for attr in ("tp_group", "tp_dims", "tp_shard_group"):
            mod.__dict__.pop(attr, None)
    return whole


def check_sharded(model: nn.Module, mesh, axis: str = "tp") -> None:
    """Raise ValueError unless `model` is a shard over the mesh's `axis`
    (shard_params' output for this rank, whose units may all be whole):
    what a recognizer given a presharded module holds to."""
    if mesh is None:
        raise ValueError("a presharded module needs the tp_mesh it was "
                         "sharded over")
    if getattr(model, "tp_shard_group", None) is not mesh.get_group(axis):
        raise ValueError("presharded: the module is not sharded over this "
                         f"mesh's {axis!r} axis (shard it with "
                         "sharding.shard_params)")
