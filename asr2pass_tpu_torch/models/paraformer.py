"""Offline Paraformer: SAN-M encoder + CIF predictor + parallel decoder.

Counterpart of the JAX package's models/paraformer.py (init, apply,
greedy_ids). One forward = encoder -> alphas -> integrate-and-fire ->
parallel decoder -> logits, batched and masked; timestamp models also
return the upsampled alphas and their peak trace. apply_sp runs the
encoder sequence-parallel (JAX's apply_sp); a model that
parallel/sharding.shard_params cut runs apply tensor-parallel, and
apply_sp with its encoder gathered whole.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.models import cif, sanm_decoder, sanm_encoder
from asr2pass_tpu_torch.models.layers import length_mask, quantized_like
from asr2pass_tpu_torch.parallel.sequence import encode_sequence_parallel
from asr2pass_tpu_torch.parallel.sharding import gather_whole
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.utils import resolve_device


class ParaformerOutput(NamedTuple):
    logits: torch.Tensor                   # [B, U, V]
    token_num: torch.Tensor                # [B]
    enc: torch.Tensor                      # [B, T, D]
    alphas: torch.Tensor                   # [B, T]
    us_alphas: Optional[torch.Tensor]      # [B, 3T] (timestamp models)
    us_cif_peak: Optional[torch.Tensor]    # [B, 3T]


class Paraformer(nn.Module):
    def __init__(self, cfg: ParaformerConfig, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.encoder = sanm_encoder.SanmEncoder(cfg.encoder, **kw)
        self.predictor = cif.CifPredictor(cfg.predictor, **kw)
        self.decoder = sanm_decoder.SanmDecoder(
            cfg.decoder, cfg.encoder.output_size, cfg.vocab_size,
            use_hotword=cfg.use_hotword, **kw)

    def forward(self, feats, lengths, hw_emb=None, hw_mask=None,
                max_tokens=None) -> ParaformerOutput:
        return apply(self, self.cfg, feats, lengths, hw_emb, hw_mask,
                     max_tokens)


def init(cfg: ParaformerConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Paraformer:
    """Random weights with the shapes and distributions of the JAX init
    (uniform dense and FSMN taps, normal conv taps, unit LayerNorm).
    The generator must live on `device`; the numbers differ from the JAX
    init's, which draws from jax.random."""
    dev = resolve_device(device)
    with torch.no_grad():
        return Paraformer(cfg, generator=generator, device=dev)


def from_state_dict(state_dict: Mapping[str, torch.Tensor],
                    cfg: ParaformerConfig, device="cuda") -> Paraformer:
    """Inference model on `device` holding `state_dict` (as
    model_zoo.params_from_jax returns it). The hotword block exists iff
    the weights carry it: a model directory's yaml does not record it.
    Each dense layer takes the form its keys have: float `w`, or the int8
    `w_q` / `w_q8` with `scale` of utils.quantize_params (an int8 model
    directory that either package saved)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, use_hotword=any(
        k.startswith("decoder.hotword.") for k in state_dict))
    model = quantized_like(Paraformer(cfg, device="meta"), state_dict)
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def apply(params, cfg: ParaformerConfig, feats, lengths, hw_emb=None,
          hw_mask=None, max_tokens=None) -> ParaformerOutput:
    """feats: [B, T, lfr_dim] LFR+CMVN features, lengths: [B]."""
    mask = length_mask(lengths, feats.shape[1])
    enc = sanm_encoder.apply(params.encoder, feats, mask,
                             d_model=cfg.encoder.output_size,
                             heads=cfg.encoder.attention_heads,
                             block_span="asr.block")
    return _predict_and_decode(params, cfg, enc, mask, lengths, hw_emb,
                               hw_mask, max_tokens)


def _predict_and_decode(params, cfg: ParaformerConfig, enc, mask, lengths,
                        hw_emb=None, hw_mask=None, max_tokens=None
                        ) -> ParaformerOutput:
    """CIF, the decoder and the timestamp head on the encodings."""
    alphas = cif.alphas_head(params.predictor, enc, cfg.predictor, mask)
    with METRICS.stage("asr.cif"):     # CIF's host loop over frames
        ac_embeds, token_num, _ = cif.fire_offline(
            enc, alphas, cfg.predictor.threshold,
            cfg.predictor.tail_threshold, max_tokens=max_tokens,
            lengths=lengths)
    tok_mask = length_mask(token_num, ac_embeds.shape[1])
    logits = sanm_decoder.apply(
        params.decoder, ac_embeds, enc, enc_mask=mask, mask=tok_mask,
        hw_emb=hw_emb, hw_mask=hw_mask, cfg=cfg.decoder,
        block_span="asr.block")
    us_alphas = us_peak = None
    if cfg.predictor.use_timestamp:
        us_alphas = cif.upsampled_alphas(params.predictor, enc,
                                         cfg.predictor, mask,
                                         token_num=token_num)
        us_peak = cif.peaks_from_alphas(us_alphas,
                                        cfg.predictor.threshold - 1e-4)
    return ParaformerOutput(logits=logits, token_num=token_num, enc=enc,
                            alphas=alphas, us_alphas=us_alphas,
                            us_cif_peak=us_peak)


def apply_sp(params, cfg: ParaformerConfig, feats, lengths, mesh,
             axis: str = "sp", max_tokens=None) -> ParaformerOutput:
    """Sequence-parallel forward for very long segments: the encoder, the
    dominant work, runs with the time axis cut over the mesh's `axis`
    (parallel/sequence.py); CIF and the decoder run on the all-gathered
    encodings on every rank. T must be a multiple of the axis size (the
    recognizer pads it); lengths [B] carry the true lengths. Every rank
    calls with the same arguments and gets the same output.

    A tensor-parallel model (sharding.shard_params) all-gathers its
    encoder's shards over tp into a whole encoder for this call
    (sharding.gather_whole), dropped when the encoder returns, and runs
    CIF and the decoder tensor-parallel, as the JAX package's `tail` jit
    runs on TP-sharded params."""
    lengths = torch.as_tensor(lengths, dtype=torch.long, device=feats.device)
    encoder = gather_whole(params.encoder)
    enc = encode_sequence_parallel(encoder, feats, cfg.encoder, mesh,
                                   axis=axis, lengths=lengths.tolist())
    del encoder
    mask = length_mask(lengths, feats.shape[1])
    return _predict_and_decode(params, cfg, enc, mask, lengths,
                               max_tokens=max_tokens)


def greedy_ids(out: ParaformerOutput):
    """Argmax token ids [B, U] + token counts [B]."""
    return out.logits.argmax(dim=-1), out.token_num
