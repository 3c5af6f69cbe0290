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
"""
from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from asr2pass_tpu_torch.models.layers import (CrossAttention, Dense, Ffn,
                                              SanmAttention)

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


def _check(model: nn.Module, specs: Dict[str, Optional[int]], n: int):
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and mod.weight_key != "w":
            raise ValueError(
                f"tensor parallelism takes a float model: {name} holds the "
                f"int8 {mod.weight_key} {tuple(mod.weight.shape)} (quantize "
                "after sharding is not supported either)")
        if isinstance(mod, (SanmAttention, CrossAttention)) and mod.heads % n:
            w = mod.qkv.w if isinstance(mod, SanmAttention) else mod.q.w
            raise ValueError(
                f"{name}: {mod.heads} heads (projection "
                f"{tuple(w.shape)}) do not split over tp={n}; the port "
                "shards attention by head")
    params = dict(model.named_parameters())
    for key, dim in specs.items():
        if dim is None:
            continue
        width = params[key].shape[dim]
        blocks = _FUSED.get(key.rsplit(".", 2)[-2], 1)
        if width % (blocks * n):
            raise ValueError(
                f"{key} {tuple(params[key].shape)}: dim {dim} of {width} "
                f"does not split over tp={n}")


def local_slice(key: str, value, dim: int, n: int, rank: int):
    """Rank `rank`'s part of one parameter: its heads' column blocks of a
    fused qkv or kv projection, else its 1/n range of `dim`."""
    blocks = _FUSED.get(key.replace("/", ".").rsplit(".", 2)[-2], 1)
    parts = [blk.chunk(n, dim)[rank] for blk in value.chunk(blocks, dim)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim)


def shard_params(model: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """This rank's local module: a copy of `model` holding its shards of
    the parameters param_specs names, its sharded modules marked with the
    mesh's `axis` group (comm.tp_group). Raises ValueError for a head
    count or a sharded width that the axis does not divide, and for a
    quantized model."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    rank = mesh.get_local_rank(axis)
    specs = param_specs(dict(model.named_parameters()))
    _check(model, specs, n)
    local = copy.deepcopy(model)
    for key, dim in specs.items():
        if dim is None:
            continue
        mod_name, pname = key.rsplit(".", 1)
        old = getattr(local.get_submodule(mod_name), pname)
        part = local_slice(key, old.detach(), dim, n, rank).clone()
        setattr(local.get_submodule(mod_name), pname,
                nn.Parameter(part, requires_grad=old.requires_grad))
    for mod in local.modules():
        if isinstance(mod, (SanmAttention, CrossAttention, Ffn)):
            mod.tp_group = group
    for key in specs:
        if _path(key).endswith(VOCAB_HEADS):
            local.get_submodule(key.rsplit(".", 1)[0]).tp_group = group
    return local


def check_sharded(model: nn.Module, mesh, axis: str = "tp") -> None:
    """Raise ValueError unless `model` is a shard over the mesh's `axis`
    (shard_params' output for this rank): what a recognizer given a
    presharded module holds to."""
    if mesh is None:
        raise ValueError("a presharded module needs the tp_mesh it was "
                         "sharded over")
    group = mesh.get_group(axis)
    if not any(getattr(m, "tp_group", None) is group
               for m in model.modules()):
        raise ValueError("presharded: the module is not sharded over this "
                         f"mesh's {axis!r} axis (shard it with "
                         "sharding.shard_params)")
