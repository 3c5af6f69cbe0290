"""Offline (pass-2) recognizer: samples -> text (+ timestamps).

Counterpart of the JAX package's runtime/offline_asr.py (ParaformerOffline:
recognize_batch = dispatch_batch + one fetch + finish_batch, with the
engine's feats_override, per-item hotword embeddings and per-item LM
decoders, and the tensor- and sequence-parallel options). Segments are
grouped by (feature-length bucket, hotword-count bucket) and run as true
batches: front-end on the device, one forward, greedy ids, then host
detokenization and bicif timestamps.
Segments with and without hotwords never share a forward: the hotword
cross-attention block runs only for a batch that has embeddings.

LM rescoring (the BeamSearch/WfstDecoder path, paraformer.cpp:410-419):
an item with an LM decoder (decode/lm_decoder.py, its native version, or
decode/tlg.TlgDecoder) is decoded on the host over the log-softmax of
its token rows. The log-softmax is taken on the device, for the LM items
only (a TLG decoder's rows gathered there to its graph's input labels),
and once the token counts are on the host, one more copy brings back the
first `count` rows of each LM item: never the [B, U, V] logits. A
rescored text that differs from the greedy one takes its timestamps
through timestamp_smooth.

Several cards (torch.distributed, one process a rank; every rank
constructs the recognizer and calls it with the same arguments, and
every rank returns the whole result list):
- tp_mesh, a ("dp", "tp") DeviceMesh: the model is sharded over tp
  (parallel/sharding.shard_params: each rank runs H/tp heads; an
  attention whose heads tp does not divide, and an int8 model, stay
  whole), and each chunk's rows are split over dp, its outputs
  all-gathered over dp;
- sp_mesh: segments over sp_threshold LFR frames (default 4096) run
  the encoder time-sharded over the mesh's sp_axis (paraformer.apply_sp),
  padded to a multiple of 64 a rank and batched by padded length. As in
  the JAX package they are decoded without hotwords.
The two combine, as in the JAX package: segments up to sp_threshold take
the TP path, rows over dp; longer ones the SP path, whose encoder is
gathered whole from the TP shards for the call and whose CIF and decoder
run tensor-parallel on every rank's whole SP batch. The sp_mesh must
then span the tp_mesh's ranks.
A server shards once and hands every recognizer the rank's shard
(presharded=True); its rank 0 sets `fanout` (server/fanout.py), through
which dispatch_batch and forward_feats reach the other ranks.

The length and batch buckets are kept from the JAX package, where they
bound the number of XLA programs. Here they decide the T that the
attention gates see and max_tokens = T//2 + 8, so the port and the JAX
recognizer compute on the same shapes; whether eager PyTorch needs them
at all is left to a later measurement.

Spans (runtime/metrics): asr.frontend, asr.forward (CIF's loop inside it
as asr.cif, models/paraformer.py), asr.fetch around each blocking copy
to the host and asr.finish; the counters asr.frames and
asr.frames_padded add each forward chunk's true LFR frames and its rows
times its bucket.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.decode.tlg import TlgDecoder
from asr2pass_tpu_torch.frontend.fbank import num_frames
from asr2pass_tpu_torch.frontend.lfr import lfr_len
from asr2pass_tpu_torch.models import paraformer
from asr2pass_tpu_torch.parallel.comm import all_gather
from asr2pass_tpu_torch.parallel.sharding import (axis_size, check_sharded,
                                                  shard_params)
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
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
    (default the card; pass device="cpu" for the plain PyTorch path).
    lm_decoder: the LM decoder of every item without one of its own in
    recognize_batch's lm_decoders (greedy when None). tp_mesh, sp_mesh,
    sp_axis, sp_threshold: see the module's docstring; presharded: params
    is already this rank's shard over tp_mesh (sharding.shard_params'
    module), used as it is."""

    fanout = None

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: ParaformerConfig, vocab: Vocab, cmvn=None,
                 lm_decoder=None, device="cuda", tp_mesh=None, sp_mesh=None,
                 sp_axis: str = "sp", sp_threshold: int = 4096,
                 presharded: bool = False):
        if tp_mesh is not None and sp_mesh is not None and sorted(
                tp_mesh.mesh.flatten().tolist()) != sorted(
                    sp_mesh.mesh.flatten().tolist()):
            raise ValueError(
                "tp_mesh and sp_mesh must span the same ranks (every rank "
                f"runs both paths): tp over {tp_mesh.mesh.tolist()}, sp over "
                f"{sp_mesh.mesh.tolist()}")
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.model = params.to(self.device).eval().requires_grad_(False)
        else:
            self.model = paraformer.from_state_dict(params, cfg, self.device)
        self.tp_mesh = tp_mesh
        self.dp, self.dp_rank, self.dp_group = 1, 0, None
        if presharded:
            check_sharded(self.model, tp_mesh)
        elif tp_mesh is not None:
            self.model = shard_params(self.model, tp_mesh)
        if tp_mesh is not None:
            if "dp" in tp_mesh.mesh_dim_names:
                self.dp = axis_size(tp_mesh, "dp")
                self.dp_rank = tp_mesh.get_local_rank("dp")
                self.dp_group = tp_mesh.get_group("dp")
        self.sp_mesh = sp_mesh
        self.sp_axis = sp_axis
        self.sp_threshold = sp_threshold
        self.cfg = cfg
        self.vocab = vocab
        self.cmvn = cmvn if cmvn is not None else (None, None)
        self.lm_decoder = lm_decoder
        # bytes of LM rows copied to the host, over the recognizer's life
        self.lm_bytes_copied = 0

    def _sp_pad_t(self, t: int) -> int:
        n = axis_size(self.sp_mesh, self.sp_axis)
        return -(-t // (n * 64)) * (n * 64)

    def _forward_sp(self, feats: torch.Tensor, lengths: List[int]):
        """Long segments as one padded batch through the
        sequence-parallel encoder: feats [B, T, lfr_dim] with T a
        multiple of _sp_pad_t's step, lengths [B] the true lengths."""
        return paraformer.apply_sp(self.model, self.cfg, feats, lengths,
                                   self.sp_mesh, axis=self.sp_axis,
                                   max_tokens=feats.shape[1] // 2 + 8)

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
                        lm_decoders: Optional[List] = None,
                        feats_override=None
                        ) -> List[Tuple[str, List[List[float]]]]:
        """Batch of raw-sample segments -> [(text, token_timestamps_s)].
        hw_embs[i]: segment i's compiled hotword embeddings [N_i, D] or
        None (hw_emb is the shorthand for one set shared by all); used
        when the model has the hotword block. lm_decoders[i]: segment
        i's LM decoder (a connection's, with its hotwords), or None for
        the recognizer's. feats_override: see dispatch_batch. All
        outputs but the LM rows come back in one copy."""
        pending, handles = self.dispatch_batch(
            segments, hw_emb=hw_emb, hw_embs=hw_embs,
            lm_decoders=lm_decoders, feats_override=feats_override)
        if handles:
            with METRICS.stage("asr.fetch"):
                handles = to_host(handles)
        return self.finish_batch(pending, handles)

    def dispatch_batch(self, segments: List[np.ndarray],
                       hw_emb: Optional[np.ndarray] = None,
                       hw_embs: Optional[List] = None,
                       lm_decoders: Optional[List] = None,
                       feats_override=None):
        """Phase A: front-end and forward on the device. Returns (pending,
        handles): `handles` are the device tensors finish_batch needs
        (the LM items' log-prob rows stay in `pending` on the device).
        feats_override(idxs, bucket, bb), when given, supplies a chunk's
        device feats (the engine's pass-2 lane gathers them from its
        device audio ring); where it returns None the segments' samples
        are uploaded. With a fan-out, on every rank of the server."""
        kw = dict(hw_emb=hw_emb, hw_embs=hw_embs, lm_decoders=lm_decoders,
                  feats_override=feats_override)
        if self.fanout is not None:
            return self.fanout.dispatch(self, segments, **kw)
        return self._dispatch(segments, **kw)

    def forward_feats(self, feats: torch.Tensor, lengths: List[int]):
        """One forward on device features [B, T, lfr_dim] (the engine's
        warm-up); with a fan-out, on every rank of the server."""
        if self.fanout is not None:
            return self.fanout.forward(self, feats, lengths)
        return self._forward(feats, lengths)

    @torch.inference_mode()
    def _dispatch(self, segments, hw_emb=None, hw_embs=None,
                  lm_decoders=None, feats_override=None, lm_flags=None):
        """dispatch_batch on this rank. lm_flags[i] (a worker rank's call):
        whether segment i has an LM decoder on rank 0, which decides the
        dp gather of the logits; this rank then computes no LM rows."""
        means, vars_ = self.cmvn
        fcfg = self.cfg.frontend
        bufs = [np.asarray(s, np.float32) for s in segments]
        ns = [num_frames(len(b), fcfg) for b in bufs]
        t_lfrs = [lfr_len(n, fcfg.lfr_m, fcfg.lfr_n) if n else 0
                  for n in ns]
        if hw_embs is None:
            hw_embs = [hw_emb] * len(bufs)
        lms = [lm_decoders[i] if lm_decoders is not None
               and lm_decoders[i] is not None else self.lm_decoder
               for i in range(len(bufs))]
        has_lm = ([lm is not None for lm in lms] if lm_flags is None
                  else [bool(x) for x in lm_flags])
        results: List[Optional[Tuple[str, List[List[float]]]]] = \
            [None] * len(bufs)
        # group by (feature bucket, hotword-count bucket; 0 = none);
        # segments past the SP threshold by their padded length
        groups, sp_groups = {}, {}
        for i, t in enumerate(t_lfrs):
            if t == 0:
                results[i] = ("", [])
                continue
            if self.sp_mesh is not None and t > self.sp_threshold:
                sp_groups.setdefault(self._sp_pad_t(t), []).append(i)
                continue
            hw = hw_embs[i]
            hw_key = 0 if hw is None else _hw_bucket(hw.shape[0])
            groups.setdefault((_bucket(t), hw_key), []).append(i)
        chunks = [(bucket, hw_key, idxs[j: j + _MAX_BATCH])
                  for (bucket, hw_key), idxs in groups.items()
                  for j in range(0, len(idxs), _MAX_BATCH)]
        records = []
        handles: list = []
        for t_pad, idxs in sp_groups.items():
            with METRICS.stage("asr.frontend"):
                feats = offline_frontend_device(
                    [bufs[i] for i in idxs], [ns[i] for i in idxs], t_pad,
                    fcfg, means, vars_, device=self.device)
            lens = [t_lfrs[i] for i in idxs]
            METRICS.count("asr.frames", sum(lens))
            METRICS.count("asr.frames_padded", len(idxs) * t_pad)
            with METRICS.stage("asr.forward"):
                out = self._forward_sp(feats, lens)
            self._record(out, idxs, lens, lms, has_lm, records, handles)
        for bucket, hw_key, idxs in chunks:
            # the rows split evenly over dp
            bb = -(-_batch_bucket(len(idxs)) // self.dp) * self.dp
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
                with METRICS.stage("asr.frontend"):
                    feats = offline_frontend_device(
                        [bufs[i] for i in idxs], [ns[i] for i in idxs],
                        bucket, fcfg, means, vars_, batch_b=bb,
                        device=self.device)
            METRICS.count("asr.frames", sum(lens))
            METRICS.count("asr.frames_padded", bb * bucket)
            # this dp rank's share of the rows (all of them without dp)
            per = bb // self.dp
            mine = slice(per * self.dp_rank, per * (self.dp_rank + 1))
            if hw_key:
                hw_batch, hw_lens = hw_batch[mine], hw_lens[mine]
            with METRICS.stage("asr.forward"):
                out = self._forward(feats[mine], lens[mine], hw_batch,
                                    hw_lens)
            self._record(out, idxs, lens, lms, has_lm, records, handles,
                         self.dp_group)
        return {"records": records, "results": results, "lms": lms}, handles

    def _record(self, out, idxs, lens, lms, has_lm, records, handles,
                group=None):
        """The handles of one forward for finish_batch (greedy ids and
        counts, the timestamp model's upsampled alphas and peaks) and its
        LM items' rows. With `group` (dp) each rank ran its share of the
        rows: the handles, and the logits where an item has an LM, are
        all-gathered over it first."""
        ids, counts = paraformer.greedy_ids(out)
        hlist = [ids, counts]
        if self.cfg.predictor.use_timestamp:
            hlist += [out.us_alphas, out.us_cif_peak]
        logits = out.logits
        if group is not None:
            hlist = [all_gather(h, 0, group) for h in hlist]
            if any(has_lm[i] for i in idxs):
                logits = all_gather(logits, 0, group)
        records.append({"idxs": idxs, "lens": lens,
                        "lm_rows": _lm_rows(logits, idxs, lms),
                        "off": len(handles), "n": len(hlist)})
        handles.extend(hlist)

    def finish_batch(self, pending, fetched
                     ) -> List[Tuple[str, List[List[float]]]]:
        """Phase B: host post-processing of the fetched (numpy) handles:
        detokenization, LM decoding and timestamps."""
        with METRICS.stage("asr.finish"):
            return self._finish(pending, fetched)

    def _finish(self, pending, fetched):
        results, lms = pending["results"], pending["lms"]
        for rec in pending["records"]:
            idxs, lens = rec["idxs"], rec["lens"]
            vals = list(fetched[rec["off"]: rec["off"] + rec["n"]])
            ids = np.asarray(vals.pop(0))
            counts = np.asarray(vals.pop(0))
            if self.cfg.predictor.use_timestamp:
                us_a_np = np.asarray(vals.pop(0))
                us_p_np = np.asarray(vals.pop(0))
            rows = self._fetch_lm_rows(rec["lm_rows"], counts)
            for k, i in enumerate(idxs):
                tok_ids = [int(x) for x in ids[k, : int(counts[k])]]
                lm_text = None
                if k in rows:
                    lm_text = _lm_decode(lms[i], rows[k], self.vocab)
                if not self.cfg.predictor.use_timestamp:
                    results[i] = (self.vocab.to_string(tok_ids)
                                  if lm_text is None else lm_text, [])
                    continue
                char_list = self.vocab.to_char_list(tok_ids)
                _, _, token_ts = ts_mod.timestamp_from_peaks(
                    us_a_np[k, : lens[k] * 3], us_p_np[k, : lens[k] * 3],
                    list(char_list))
                text, merged = ts_mod.post_process(char_list, token_ts)
                if lm_text is not None and lm_text != text:
                    # the CIF timestamps re-aligned to the rescored text
                    # (the reference re-derives them through the decoder,
                    # wfst-decoder.cpp:59-92; this reuses ITN's alignment)
                    merged = ts_mod.timestamp_smooth(text, lm_text,
                                                     merged) or merged
                    text = lm_text
                results[i] = (text, merged)
        return [r if r is not None else ("", []) for r in results]

    def _fetch_lm_rows(self, lm_rows: dict, counts: np.ndarray) -> dict:
        """{k: device log-prob rows [U, *]} -> {k: host rows [count_k, *]}
        for the items with a token, in one copy."""
        keep = [k for k in lm_rows if int(counts[k]) > 0]
        if not keep:
            return {}
        parts = [lm_rows[k][: int(counts[k])] for k in keep]
        flat = torch.cat([x.reshape(-1) for x in parts])
        with METRICS.stage("asr.fetch"):
            flat = flat.cpu().numpy()
        self.lm_bytes_copied += flat.nbytes
        out, at = {}, 0
        for k, x in zip(keep, parts):
            out[k] = flat[at: at + x.numel()].reshape(tuple(x.shape))
            at += x.numel()
        return out

    def recognize(self, samples: np.ndarray,
                  hw_emb: Optional[np.ndarray] = None
                  ) -> Tuple[str, List[List[float]]]:
        return self.recognize_batch([samples], hw_emb=hw_emb)[0]


def _lm_rows(logits: torch.Tensor, idxs: List[int], lms: List) -> dict:
    """{k: the log-softmax rows of batch row k} on the device, for the
    rows whose item has an LM decoder; a TLG decoder's gathered to its
    graph's input labels."""
    rows = {}
    for k, i in enumerate(idxs):
        if lms[i] is not None:
            lp = torch.log_softmax(logits[k].float(), dim=-1)
            rows[k] = (lms[i].graph.gather_rows(lp)
                       if isinstance(lms[i], TlgDecoder) else lp)
    return rows


def _lm_decode(lm, rows: np.ndarray, vocab: Vocab) -> str:
    """One utterance's text from an LM decoder over its host rows
    (_lm_rows' layout for that decoder)."""
    lm.start_utterance()
    if isinstance(lm, TlgDecoder):
        return lm.decode_ilabel_rows(rows)
    return lm.decode(rows, vocab.id2token)
