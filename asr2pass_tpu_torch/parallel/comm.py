"""Collectives on a torch.distributed group, and the Megatron pair that
lets autograd run through tensor parallelism.

The JAX package has no such file: there GSPMD derives every collective
from the parameter shardings (parallel/sharding.py), and shard_map's
psum / all_gather / ppermute serve the sequence-parallel encoder and the
sharded CTC prune. The port writes them out:

  all_reduce(x, op, group)       sum or max over the group, in place
  all_gather(x, dim, group)      the ranks' tensors concatenated along dim
  halo_exchange(x, halo, group)  `halo` frames of each ring neighbour on
                                 both sides of the time axis, zero at the
                                 sequence's ends (JAX's ppermute pair,
                                 sequence.py:33-47), by batch_isend_irecv
  broadcast(x, src, group)       a group rank's tensor on every rank, in
                                 place (the serving fan-out's feature
                                 tensors, server/fanout.py)
  broadcast_object(obj, src, group)  a picklable object from a group rank:
                                 its length, then its pickled bytes, as
                                 two broadcasts (the fan-out's call
                                 headers, on a gloo group of CPU tensors)

and, as torch.autograd.Functions, the conjugate pair of Megatron-style
tensor parallelism and the gather of a vocab-sharded head:

  copy_to_tp(x, group)       identity forward, all-reduce backward: the
                             entry of a column-parallel layer, whose input
                             is replicated and whose input gradient each
                             rank holds only a part of
  reduce_from_tp(x, group)   all-reduce forward, identity backward: the
                             exit of a row-parallel layer. (torch.
                             distributed.nn.functional.all_reduce would
                             all-reduce the gradient again, which, with
                             the loss replicated over the group,
                             multiplies it by the group's size.)
  gather_from_tp(x, dim, group)  all-gather forward, this rank's slice of
                             the gradient backward (the loss downstream
                             is replicated, so every rank holds the same
                             whole gradient)

Every function is SPMD: each rank of the group calls it, in the same
order, with tensors of the same shape. With group None they are the
identity (halo_exchange pads zeros): one process, no collective. A group
of size 1 still runs its collectives, so a one-card run exercises NCCL.
A collective that does not complete raises on the process group's
timeout (multihost.init_distributed sets it).

collective_counts() counts the calls of each collective since the last
reset_collective_counts(), for the collectives-a-forward numbers.
"""
from __future__ import annotations

import pickle
from collections import Counter
from typing import Any, Optional

import torch
import torch.distributed as dist

_COUNTS: Counter = Counter()


def collective_counts() -> dict:
    """{"all_reduce": n, "all_gather": n, "halo": n, "broadcast": n}."""
    return {k: _COUNTS[k]
            for k in ("all_reduce", "all_gather", "halo", "broadcast")}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """x reduced over the group (op "sum" or "max"), in place; returned."""
    if group is None:
        return x
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's tensors (of equal shape), rank order, concatenated along
    `dim`: jax.lax.all_gather(..., tiled=True)."""
    if group is None:
        return x
    _COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """[B, t, D] -> [B, halo + t + halo, D]: the last `halo` frames of the
    rank before and the first `halo` frames of the rank after, in the
    group's rank order (the time axis sharded in that order); zeros at
    the sequence's two ends, where the JAX package's ring ppermute
    delivers the wrapped-around frames and zeroes them."""
    b, t, d = x.shape
    if halo == 0:
        return x
    if t < halo:
        raise ValueError(f"a shard of {t} frames cannot give a halo of "
                         f"{halo}")
    n, r = group_size(group), group_rank(group)
    from_left = x.new_zeros((b, halo, d))
    from_right = x.new_zeros((b, halo, d))
    ops = []
    if r > 0:
        left = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), left, group,
                           tag=1),
                dist.P2POp(dist.irecv, from_left, left, group, tag=0)]
    if r < n - 1:
        right = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), right,
                           group, tag=0),
                dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
    if ops:
        _COUNTS["halo"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_left, x, from_right], dim=1)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """x as group rank `src` holds it, on every rank of the group, in
    place (x must have the same shape and dtype everywhere); returned."""
    if group is None:
        return x
    _COUNTS["broadcast"] += 1
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def broadcast_object(obj: Any = None, src: int = 0, group=None):
    """(obj as group rank `src` holds it, its pickled size in bytes) on
    every rank; the other ranks pass None. Two broadcasts of CPU tensors:
    the size, then the bytes (so the group must be a gloo one)."""
    if group is None:
        return obj, 0
    mine = group_rank(group) == src
    if mine:
        raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(raw)], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    broadcast(n, src, group)
    size = int(n[0])
    buf = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if mine
           else torch.empty(size, dtype=torch.uint8))
    broadcast(buf, src, group)
    return (obj if mine else pickle.loads(buf.numpy().tobytes())), size


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), "sum", ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width), None, None


def copy_to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity; its gradient is all-reduced over the group."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the group (in place where autograd records nothing);
    its gradient passes through unchanged."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTp.apply(x, group)
    return all_reduce(x, "sum", group)


def gather_from_tp(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's shards of x concatenated along dim; the gradient of
    this rank's shard is its slice of the (replicated) whole gradient."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromTp.apply(x, dim, group)
    return all_gather(x, dim, group)


def tp_group(module) -> Optional[object]:
    """The tensor-parallel group a module was sharded over
    (sharding.shard_params sets it), or None for a whole module."""
    return getattr(module, "tp_group", None)
