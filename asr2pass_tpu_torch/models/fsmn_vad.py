"""FSMN-VAD scoring network.

Counterpart of the JAX package's models/fsmn_vad.py (FunASR FSMN semantics):
in-affine 400->140->250 (two stacked linears, one ReLU after the second),
then `fsmn_layers` sequential blocks of (linear 250->128 without bias,
depthwise causal memory conv of lorder taps with an inner residual,
affine 128->250, ReLU) with no outer residual, then out-affine
250->140->248 (no activation between) and a softmax over the pdfs. The
caches are a list, one [B, cache_frames, proj_dim] tensor per block, so
many streams advance in one call.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from asr2pass_tpu_torch.config import VadConfig
from asr2pass_tpu_torch.models.layers import Dense, dense
from asr2pass_tpu_torch.utils import resolve_device

_IN_AFFINE = 140


class VadBlock(nn.Module):
    def __init__(self, cfg: VadConfig, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.proj = Dense(cfg.hidden_dim, cfg.proj_dim, bias=False, **kw)
        taps = torch.empty((cfg.lorder, cfg.proj_dim), device=device)
        self.taps = nn.Parameter(taps.normal_(generator=generator)
                                 * (1.0 / math.sqrt(cfg.lorder)))
        self.affine = Dense(cfg.proj_dim, cfg.hidden_dim, **kw)


class FsmnVad(nn.Module):
    def __init__(self, cfg: VadConfig, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.in1 = Dense(cfg.input_dim, _IN_AFFINE, **kw)
        self.in2 = Dense(_IN_AFFINE, cfg.hidden_dim, **kw)
        self.out1 = Dense(cfg.hidden_dim, _IN_AFFINE, **kw)
        self.out2 = Dense(_IN_AFFINE, cfg.output_dim, **kw)
        self.blocks = nn.ModuleList(VadBlock(cfg, **kw)
                                    for _ in range(cfg.fsmn_layers))

    def forward(self, feats, caches, valid_len=None):
        return apply(self, feats, caches, valid_len)


def init(cfg: VadConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> FsmnVad:
    """Random weights with the shapes and distributions of the JAX init.
    The generator must live on `device`."""
    dev = resolve_device(device)
    with torch.no_grad():
        return FsmnVad(cfg, generator=generator, device=dev)


def from_state_dict(state_dict, cfg: VadConfig, device="cuda") -> FsmnVad:
    """Inference model on `device` holding `state_dict` (as
    model_zoo.params_from_jax returns it)."""
    dev = resolve_device(device)
    model = FsmnVad(cfg, device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def init_caches(cfg: VadConfig, batch: int, device="cuda"
                ) -> List[torch.Tensor]:
    """Zero caches, one [B, cache_frames, proj_dim] per block."""
    dev = resolve_device(device)
    return [torch.zeros(batch, cfg.cache_frames, cfg.proj_dim,
                        dtype=torch.float32, device=dev)
            for _ in range(cfg.fsmn_layers)]


def apply(params, feats, caches, valid_len=None
          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """feats: [B, T, input_dim] LFR(5,1)+CMVN features, right-padded.
    Returns (probs [B, T, output_dim] softmax posteriors, new caches).
    With valid_len [B] the caches advance by exactly valid_len frames."""
    x = torch.relu(dense(params.in2, dense(params.in1, feats)))
    new_caches = []
    t = feats.shape[1]
    for block, cache in zip(params.blocks, caches):
        p = dense(block.proj, x)                          # [B, T, proj]
        lorder = block.taps.shape[0]
        ext = torch.cat([cache, p], dim=1)                # [B, C+T, proj]
        mem = torch.zeros_like(p)
        for k in range(lorder):
            mem = mem + ext[:, k: k + t, :] * block.taps[k]
        mem = mem + p                                     # inner residual
        c = cache.shape[1]
        if valid_len is None:
            new_caches.append(ext[:, -c:, :])
        else:
            idx = (valid_len.long()[:, None]
                   + torch.arange(c, device=feats.device)[None, :])
            new_caches.append(torch.take_along_dim(ext, idx[..., None],
                                                   dim=1))
        # sequential, no outer residual (FunASR's plain nn.Sequential)
        x = torch.relu(dense(block.affine, mem))
    logits = dense(params.out2, dense(params.out1, x))
    return torch.softmax(logits, dim=-1), new_caches
