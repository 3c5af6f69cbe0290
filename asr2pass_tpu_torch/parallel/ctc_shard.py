"""Device-side first prune of the CTC prefix beam, whole or over a
vocab-sharded CTC head.

Counterpart of the JAX package's parallel/ctc_shard.py (ctc_first_prune,
ctc_first_prune_gather, ctc_gather_logp, ctc_first_prune_sharded; the
recognizer's ctc_gather_logp over sharded logits, which GSPMD partitions
there, is ctc_first_prune_sharded_gather here). The host
prefix beam (decode/ctc.py) consumes only each frame's top-k candidates,
so the device computes that set and [B, T, k] ids and log-probs reach the
host instead of the [B, T, V] logits (V = 25055 for SenseVoice-small).
Each function is a log-softmax, a torch.topk and a gather on the logits'
device. Over a tensor-parallel CTC head (ctc_first_prune_sharded) each
rank holds its V/tp logit columns: the log-softmax is normalised over the
whole vocab by an all-reduce of the max and of the exp-sum, each rank
takes its local top-k, and the candidate sets are all-gathered and
re-reduced to the global top-k: beam state exchanged between the cards.

Ties: torch.topk and jax.lax.top_k may order equal scores differently,
so a candidate set is the same set of (id, log-prob) pairs, not always
the same order.
"""
from __future__ import annotations

from typing import Sequence

import torch

from asr2pass_tpu_torch.parallel.comm import (all_gather, all_reduce,
                                              group_rank, group_size)


def ctc_first_prune(logits: torch.Tensor, k: int = 64):
    """[B, T, V] logits -> (ids [B, T, k] int64, logp [B, T, k] fp32),
    k capped at V."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, ids = torch.topk(logp, min(k, logits.shape[-1]), dim=-1)
    return ids, scores


def ctc_first_prune_gather(logits: torch.Tensor, ids: Sequence[int],
                           k: int = 64):
    """First prune plus the log-probs of an explicit id set: one
    log-softmax serves the top-k set and the force-included context-unit
    columns. Returns (ids [B, T, k], logp [B, T, k], logp [B, T, E])."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, top = torch.topk(logp, min(k, logits.shape[-1]), dim=-1)
    cols = torch.as_tensor(list(ids), dtype=torch.long, device=logp.device)
    return top, scores, logp.index_select(-1, cols)


def ctc_gather_logp(logits: torch.Tensor, ids: Sequence[int]):
    """Log-probs of an explicit id set for every frame: [B, T, V] logits
    + [E] ids -> [B, T, E]. The context graph's unit ids are
    force-included into the beam's candidates with these, so the top-k
    prune never hides a hotword unit from the bias
    (ctc-prefix-decoder.cpp:280-299 biases the full-vocab beam)."""
    cols = torch.as_tensor(list(ids), dtype=torch.long, device=logits.device)
    return torch.log_softmax(logits.float(), dim=-1).index_select(-1, cols)


def _sharded_logp(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's columns of the whole vocab's log-softmax: the max and
    the exp-sum all-reduced over the group."""
    m = all_reduce(x.amax(dim=-1), "max", group)                  # [B, T]
    z = all_reduce(torch.exp(x - m[..., None]).sum(dim=-1), "sum", group)
    return x - m[..., None] - torch.log(z)[..., None]


def ctc_first_prune_sharded(logits: torch.Tensor, mesh, axis: str = "tp",
                            k: int = 64):
    """Vocab-sharded first prune. logits: this rank's [B, T, V/n] columns
    (rank r holds [r V/n, (r+1) V/n), as sharding.shard_params cuts the
    head; every rank of the mesh's `axis` calls with its own). Returns
    the same (ids [B, T, k'], logp [B, T, k']) on every rank, with
    k' = min(k, n * min(k, V/n)), log-probs normalised over the whole
    vocab. Standard distributed-top-k caveat: each shard contributes at
    most min(k, V/n) candidates, so when V/n > k the set can miss a
    candidate if one shard holds more than k of the global top-k
    (vanishingly rare for softmax rows; exact whenever V/n <= k)."""
    group = mesh.get_group(axis)
    return _sharded_topk(_sharded_logp(logits.float(), group), group, k)


def _sharded_topk(logp: torch.Tensor, group, k: int):
    vshard = logp.shape[-1]
    local_k = min(k, vshard)
    final_k = min(k, group_size(group) * local_k)
    sc, idx = torch.topk(logp, local_k, dim=-1)                   # local
    idx = idx + group_rank(group) * vshard                        # global
    sc_all = all_gather(sc, 2, group)
    idx_all = all_gather(idx, 2, group)
    sc2, pos = torch.topk(sc_all, final_k, dim=-1)
    return torch.gather(idx_all, -1, pos), sc2


def ctc_first_prune_sharded_gather(logits: torch.Tensor, ids: Sequence[int],
                                   mesh, axis: str = "tp", k: int = 64):
    """ctc_first_prune_sharded plus the whole-vocab log-probs of an
    explicit id set (ctc_first_prune_gather's third output): each rank
    reads the ids in its columns from the same normalisation, zeros the
    rest, and one all-reduce sums them. Returns (ids [B, T, k'],
    logp [B, T, k'], logp [B, T, E]) on every rank."""
    group = mesh.get_group(axis)
    logp = _sharded_logp(logits.float(), group)
    top, scores = _sharded_topk(logp, group, k)
    vshard = logp.shape[-1]
    cols = torch.as_tensor(list(ids), dtype=torch.long,
                           device=logp.device) - group_rank(group) * vshard
    mine = (cols >= 0) & (cols < vshard)
    picked = logp.index_select(-1, cols.clamp(0, vshard - 1))
    return top, scores, all_reduce(torch.where(mine, picked, 0.0), "sum",
                                   group)
