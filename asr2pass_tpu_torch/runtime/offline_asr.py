"""Offline (pass-2) recognizer: samples -> text (+ timestamps).

Counterpart of the JAX package's runtime/offline_asr.py (ParaformerOffline:
recognize_batch = dispatch_batch + one fetch + finish_batch, with the
engine's feats_override and per-item hotword embeddings), without the LM
rescoring and sequence-parallel branches, which come with later slices.
Segments are grouped by (feature-length bucket, hotword-count bucket) and
run as true batches: front-end on the device, one forward, greedy ids,
then host detokenization and bicif timestamps. Segments with and without
hotwords never share a forward: the hotword cross-attention block runs
only for a batch that has embeddings.

The length and batch buckets are kept from the JAX package, where they
bound the number of XLA programs. Here they decide the T that the
attention gates see and max_tokens = T//2 + 8, so the port and the JAX
recognizer compute on the same shapes; whether eager PyTorch needs them
at all is left to a later measurement.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.frontend.fbank import num_frames
from asr2pass_tpu_torch.frontend.lfr import lfr_len
from asr2pass_tpu_torch.models import paraformer
from asr2pass_tpu_torch.runtime.streaming_frontend import offline_frontend_device
from asr2pass_tpu_torch.text import timestamps as ts_mod
from asr2pass_tpu_torch.text.vocab import Vocab
from asr2pass_tpu_torch.utils import fp32_products, resolve_device, to_host

# feature-length buckets (LFR frames, 60 ms each): 3.8 s .. 61 s; longer
# segments round up to a multiple of the last bucket
_BUCKETS = [64, 128, 256, 512, 1024]
# batch buckets; larger groups split into chunks of 16
_BATCH_BUCKETS = [1, 2, 4, 8, 16]
_MAX_BATCH = _BATCH_BUCKETS[-1]


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


def _batch_bucket(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return _MAX_BATCH


# hotword-count buckets (rows of the compiled [N, D] embedding batch)
_HW_BUCKETS = [4, 8, 16, 32, 64]


def _hw_bucket(n: int) -> int:
    for b in _HW_BUCKETS:
        if n <= b:
            return b
    return -(-n // _HW_BUCKETS[-1]) * _HW_BUCKETS[-1]


class ParaformerOffline:
    """params: a Paraformer module, or its state dict (as
    model_zoo.load_offline_bundle returns it). The model runs on `device`
    (default the card; pass device="cpu" for the plain PyTorch path)."""

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: ParaformerConfig, vocab: Vocab, cmvn=None,
                 device="cuda"):
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.model = params.to(self.device).eval().requires_grad_(False)
        else:
            self.model = paraformer.from_state_dict(params, cfg, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.cmvn = cmvn if cmvn is not None else (None, None)

    def _forward(self, feats: torch.Tensor, lengths: List[int],
                 hw_batch: Optional[np.ndarray] = None,
                 hw_lens: Optional[List[int]] = None):
        """hw_batch [B, N, D]: each row's hotword embeddings padded to N
        rows; hw_lens [B] their counts (0 for a padded batch row). The
        rows past a count are masked out of the bias cross-attention."""
        t = feats.shape[1]
        hw = hw_mask = None
        if hw_batch is not None and self.model.decoder.hotword is not None:
            hw = torch.as_tensor(np.asarray(hw_batch, np.float32),
                                 device=self.device)
            hw_mask = (torch.arange(hw.shape[1], device=self.device)[None, :]
                       < torch.tensor(hw_lens, device=self.device)[:, None]
                       ).float()
        # trained CIF fires ~1 token per 3+ LFR frames; T//2+8 slots
        return paraformer.apply(
            self.model, self.cfg, feats,
            torch.tensor(lengths, dtype=torch.long, device=self.device),
            hw, hw_mask, max_tokens=t // 2 + 8)

    def recognize_batch(self, segments: List[np.ndarray],
                        hw_emb: Optional[np.ndarray] = None,
                        hw_embs: Optional[List] = None,
                        feats_override=None
                        ) -> List[Tuple[str, List[List[float]]]]:
        """Batch of raw-sample segments -> [(text, token_timestamps_s)].
        hw_embs[i]: segment i's compiled hotword embeddings [N_i, D] or
        None (hw_emb is the shorthand for one set shared by all); used
        when the model has the hotword block. feats_override: see
        dispatch_batch. All outputs come back in one copy."""
        pending, handles = self.dispatch_batch(
            segments, hw_emb=hw_emb, hw_embs=hw_embs,
            feats_override=feats_override)
        return self.finish_batch(pending, to_host(handles))

    @torch.inference_mode()
    def dispatch_batch(self, segments: List[np.ndarray],
                       hw_emb: Optional[np.ndarray] = None,
                       hw_embs: Optional[List] = None,
                       feats_override=None):
        """Phase A: front-end and forward on the device. Returns (pending,
        handles): `handles` are the device tensors finish_batch needs.
        feats_override(idxs, bucket, bb), when given, supplies a chunk's
        device feats (the engine's pass-2 lane gathers them from its
        device audio ring); where it returns None the segments' samples
        are uploaded."""
        means, vars_ = self.cmvn
        fcfg = self.cfg.frontend
        bufs = [np.asarray(s, np.float32) for s in segments]
        ns = [num_frames(len(b), fcfg) for b in bufs]
        t_lfrs = [lfr_len(n, fcfg.lfr_m, fcfg.lfr_n) if n else 0
                  for n in ns]
        if hw_embs is None:
            hw_embs = [hw_emb] * len(bufs)
        results: List[Optional[Tuple[str, List[List[float]]]]] = \
            [None] * len(bufs)
        # group by (feature bucket, hotword-count bucket; 0 = none)
        groups = {}
        for i, t in enumerate(t_lfrs):
            if t == 0:
                results[i] = ("", [])
                continue
            hw = hw_embs[i]
            hw_key = 0 if hw is None else _hw_bucket(hw.shape[0])
            groups.setdefault((_bucket(t), hw_key), []).append(i)
        chunks = [(bucket, hw_key, idxs[j: j + _MAX_BATCH])
                  for (bucket, hw_key), idxs in groups.items()
                  for j in range(0, len(idxs), _MAX_BATCH)]
        records = []
        handles: list = []
        for bucket, hw_key, idxs in chunks:
            bb = _batch_bucket(len(idxs))
            lens = [0] * bb   # padded rows have length 0 (mask empty)
            hw_batch = hw_lens = None
            if hw_key:
                hw_batch = np.zeros((bb, hw_key, hw_embs[idxs[0]].shape[1]),
                                    np.float32)
                hw_lens = [0] * bb
            for k, i in enumerate(idxs):
                lens[k] = t_lfrs[i]
                if hw_key:
                    hw_batch[k, : hw_embs[i].shape[0]] = hw_embs[i]
                    hw_lens[k] = hw_embs[i].shape[0]
            feats = (feats_override(idxs, bucket, bb)
                     if feats_override is not None else None)
            if feats is None:
                feats = offline_frontend_device(
                    [bufs[i] for i in idxs], [ns[i] for i in idxs], bucket,
                    fcfg, means, vars_, batch_b=bb, device=self.device)
            out = self._forward(feats, lens, hw_batch, hw_lens)
            ids, counts = paraformer.greedy_ids(out)
            hlist = [ids, counts]
            if self.cfg.predictor.use_timestamp:
                hlist += [out.us_alphas, out.us_cif_peak]
            records.append({"idxs": idxs, "lens": lens,
                            "off": len(handles), "n": len(hlist)})
            handles.extend(hlist)
        return {"records": records, "results": results}, handles

    def finish_batch(self, pending, fetched
                     ) -> List[Tuple[str, List[List[float]]]]:
        """Phase B: host post-processing of the fetched (numpy) handles:
        detokenization and timestamps."""
        results = pending["results"]
        for rec in pending["records"]:
            idxs, lens = rec["idxs"], rec["lens"]
            vals = list(fetched[rec["off"]: rec["off"] + rec["n"]])
            ids = np.asarray(vals.pop(0))
            counts = np.asarray(vals.pop(0))
            if self.cfg.predictor.use_timestamp:
                us_a_np = np.asarray(vals.pop(0))
                us_p_np = np.asarray(vals.pop(0))
            for k, i in enumerate(idxs):
                tok_ids = [int(x) for x in ids[k, : int(counts[k])]]
                if not self.cfg.predictor.use_timestamp:
                    results[i] = (self.vocab.to_string(tok_ids), [])
                    continue
                char_list = self.vocab.to_char_list(tok_ids)
                _, _, token_ts = ts_mod.timestamp_from_peaks(
                    us_a_np[k, : lens[k] * 3], us_p_np[k, : lens[k] * 3],
                    list(char_list))
                results[i] = ts_mod.post_process(char_list, token_ts)
        return [r if r is not None else ("", []) for r in results]

    def recognize(self, samples: np.ndarray,
                  hw_emb: Optional[np.ndarray] = None
                  ) -> Tuple[str, List[List[float]]]:
        return self.recognize_batch([samples], hw_emb=hw_emb)[0]
