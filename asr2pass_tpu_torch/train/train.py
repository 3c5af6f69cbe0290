"""Paraformer fine-tune step: label-smoothed CE over the parallel decoder
plus the CIF quantity loss.

Counterpart of the JAX package's train/train.py (TrainBatch,
make_optimizer, loss_fn, train_step, make_sharded_train_step).

Loss = label-smoothed CE over the decoder's logits, whose acoustic
embeddings come from CIF fires on the alphas rescaled so that each
utterance fires exactly target_len times, + |sum(alphas) - target_len|.
The step updates the module in place with torch.optim.AdamW, set to
optax.adamw's defaults.

Segments of MIN_T (256) LFR frames or more reach the CUDA attention
kernels on the card, which have no backward: the entry points raise
there (ops/attention.refuse_autograd), as the JAX package's Pallas
kernels cannot be differentiated either. Train on shorter segments.

make_sharded_train_step: dp batch, tp params, on a ("dp", "tp")
DeviceMesh. Each rank trains its local module (parallel/sharding.
shard_params; autograd runs through the tp collectives, comm.copy_to_tp
and reduce_from_tp) on its dp share of the batch's rows. The loss's
token count and utterance count are all-reduced over dp as denominators,
so each rank's loss is its share of the whole batch's and the gradients,
summed over dp, are the whole batch's: the step equals train_step on the
whole batch. AdamW runs on each rank's shards: it is elementwise, so
that is exact. A unit that shard_params keeps whole (an attention whose
heads tp does not divide) runs on the replicated activations, so its
gradient is the whole one on every tp rank and, like the replicated
layer norms', is reduced over dp only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
from asr2pass_tpu_torch.models.layers import length_mask
from asr2pass_tpu_torch.parallel.comm import all_reduce
from asr2pass_tpu_torch.parallel.sharding import axis_size


class TrainBatch(NamedTuple):
    feats: torch.Tensor        # [B, T, lfr_dim]
    feat_lens: torch.Tensor    # [B]
    targets: torch.Tensor      # [B, U] token ids
    target_lens: torch.Tensor  # [B]


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every float parameter of `model`, with optax.adamw's
    betas (0.9, 0.999), eps 1e-8 and decoupled weight decay. Switches
    gradients on for those parameters (the models are built without)."""
    params = [p for p in model.parameters() if p.is_floating_point()]
    for p in params:
        p.requires_grad_(True)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def loss_fn(model, cfg: ParaformerConfig, batch: TrainBatch,
            label_smoothing: float = 0.1, quantity_weight: float = 1.0,
            dp_group=None) -> Tuple[torch.Tensor, dict]:
    """(loss, {"ce", "quantity", "acc"}) of one batch; the metrics are
    detached scalars on the model's device. With dp_group the batch is
    this rank's share of one whose token and utterance counts are summed
    over the group: the loss is the rank's share of the whole batch's,
    the metrics are the whole batch's."""
    mask = length_mask(batch.feat_lens, batch.feats.shape[1])
    enc = sanm_encoder.apply(model.encoder, batch.feats, mask,
                             d_model=cfg.encoder.output_size,
                             heads=cfg.encoder.attention_heads)
    alphas = cif.alphas_head(model.predictor, enc, cfg.predictor, mask)
    target_lens = batch.target_lens.float()
    mass = alphas.sum(dim=1)
    qty = (mass - target_lens).abs()
    # scaled-alpha CIF: each utterance fires target_len times
    scale = target_lens / mass.clamp_min(1e-6)
    ac, _, _, _ = cif.fire(enc, alphas * scale[:, None],
                           cfg.predictor.threshold)
    u = batch.targets.shape[1]
    ac = ac[:, :u, :]
    tmask = length_mask(batch.target_lens, u)
    logits = sanm_decoder.apply(model.decoder, ac, enc, enc_mask=mask,
                                mask=tmask, cfg=cfg.decoder)
    v = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    soft = (F.one_hot(batch.targets.long(), v).float()
            * (1 - label_smoothing) + label_smoothing / v)
    ce_sum = (-(soft * logp).sum(dim=-1) * tmask).sum()
    correct = ((logits.argmax(dim=-1) == batch.targets).float()
               * tmask).sum()
    if dp_group is not None:
        return _dp_loss(ce_sum, qty.sum(), correct, tmask.sum(),
                        qty.shape[0], quantity_weight, dp_group)
    n_tok = tmask.sum().clamp_min(1.0)
    ce = ce_sum / n_tok
    qty_loss = qty.mean()
    loss = ce + quantity_weight * qty_loss
    acc = correct / n_tok
    return loss, {"ce": ce.detach(), "quantity": qty_loss.detach(),
                  "acc": acc.detach()}


def _dp_loss(ce_sum, qty_sum, correct, n_tok, n_utt: int,
             quantity_weight: float, group):
    """The rank's share of the whole batch's loss (local numerators over
    the dp-summed token and utterance counts), and the whole batch's
    metrics."""
    counts = torch.stack([n_tok.detach(), n_tok.new_tensor(float(n_utt))])
    n_tok_all, n_utt_all = all_reduce(counts, "sum", group)
    n_tok_all = n_tok_all.clamp_min(1.0)
    ce = ce_sum / n_tok_all
    qty_loss = qty_sum / n_utt_all
    loss = ce + quantity_weight * qty_loss
    sums = all_reduce(torch.stack([loss, ce, qty_loss, correct / n_tok_all])
                      .detach(), "sum", group)
    return loss, {"ce": sums[1], "quantity": sums[2], "acc": sums[3],
                  "loss": sums[0]}


def train_step(model, optimizer: torch.optim.Optimizer, batch: TrainBatch,
               cfg: ParaformerConfig) -> dict:
    """One step in place: loss, gradients, AdamW. A parameter outside the
    loss (the bicif head, the hotword block) gets a zero gradient, so it
    decays as optax decays every leaf. Returns the detached metrics and
    the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, cfg, batch)
    loss.backward()
    _gradients(optimizer)
    optimizer.step()
    return dict(metrics, loss=loss.detach())


def _gradients(optimizer: torch.optim.Optimizer) -> list:
    """The optimizer's parameters, each with a gradient (zeros for one
    outside the loss)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def make_sharded_train_step(cfg: ParaformerConfig, mesh):
    """step(model, optimizer, batch) -> metrics over a ("dp", "tp")
    DeviceMesh. model: this rank's shard_params(model, mesh) module;
    optimizer: make_optimizer(model); batch: the whole batch, the same on
    every rank (its rows divisible by dp), of which the rank takes its dp
    share. Updates the local module in place and returns the whole
    batch's detached metrics and loss, equal on every rank."""
    names = mesh.mesh_dim_names
    dp = axis_size(mesh, "dp") if "dp" in names else 1
    rank = mesh.get_local_rank("dp") if "dp" in names else 0
    group = mesh.get_group("dp") if "dp" in names else None

    def step(model, optimizer: torch.optim.Optimizer,
             batch: TrainBatch) -> dict:
        b = batch.feats.shape[0]
        if b % dp:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"dp={dp}")
        per = b // dp
        mine = TrainBatch(*(x[per * rank: per * rank + per] for x in batch))
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, cfg, mine, dp_group=group)
        loss.backward()
        params = _gradients(optimizer)
        if group is not None:
            # one all-reduce of all gradients, flattened
            flat = all_reduce(torch.cat([p.grad.reshape(-1)
                                         for p in params]), "sum", group)
            at = 0
            for p in params:
                p.grad.copy_(flat[at: at + p.numel()].view_as(p.grad))
                at += p.numel()
        optimizer.step()
        return dict(metrics, loss=metrics.get("loss", loss.detach()))

    return step
