"""Paraformer fine-tune step: label-smoothed CE over the parallel decoder
plus the CIF quantity loss.

Counterpart of the JAX package's train/train.py:23-80 (TrainBatch,
make_optimizer, loss_fn, train_step). The mesh-sharded step
(make_sharded_train_step) comes with the multi-device slice.

Loss = label-smoothed CE over the decoder's logits, whose acoustic
embeddings come from CIF fires on the alphas rescaled so that each
utterance fires exactly target_len times, + |sum(alphas) - target_len|.
The step updates the module in place with torch.optim.AdamW, set to
optax.adamw's defaults.

Segments of MIN_T (256) LFR frames or more reach the CUDA attention
kernels on the card, which have no backward: the entry points raise
there (ops/attention.refuse_autograd), as the JAX package's Pallas
kernels cannot be differentiated either. Train on shorter segments.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
from asr2pass_tpu_torch.models.layers import length_mask


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
            label_smoothing: float = 0.1, quantity_weight: float = 1.0
            ) -> Tuple[torch.Tensor, dict]:
    """(loss, {"ce", "quantity", "acc"}) of one batch; the metrics are
    detached scalars on the model's device."""
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
    n_tok = tmask.sum().clamp_min(1.0)
    ce = (-(soft * logp).sum(dim=-1) * tmask).sum() / n_tok
    qty_loss = qty.mean()
    loss = ce + quantity_weight * qty_loss
    acc = ((logits.argmax(dim=-1) == batch.targets).float()
           * tmask).sum() / n_tok
    return loss, {"ce": ce.detach(), "quantity": qty_loss.detach(),
                  "acc": acc.detach()}


def train_step(model, optimizer: torch.optim.Optimizer, batch: TrainBatch,
               cfg: ParaformerConfig) -> dict:
    """One step in place: loss, gradients, AdamW. A parameter outside the
    loss (the bicif head, the hotword block) gets a zero gradient, so it
    decays as optax decays every leaf. Returns the detached metrics and
    the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, cfg, batch)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    return dict(metrics, loss=loss.detach())
