"""Device-side first prune of the CTC prefix beam.

Counterpart of the unsharded half of the JAX package's parallel/ctc_shard.py
(ctc_first_prune, ctc_first_prune_gather, ctc_gather_logp). The host
prefix beam (decode/ctc.py) consumes only each frame's top-k candidates,
so the device computes that set and [B, T, k] ids and log-probs reach the
host instead of the [B, T, V] logits (V = 25055 for SenseVoice-small).
Each function is a log-softmax, a torch.topk and a gather on the logits'
device. The vocab-sharded prune over a tensor-parallel CTC head
(ctc_first_prune_sharded) comes with multi-GPU support.

Ties: torch.topk and jax.lax.top_k may order equal scores differently,
so a candidate set is the same set of (id, log-prob) pairs, not always
the same order.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
