"""SenseVoice recognizer: pass-2-compatible multilingual CTC.

Counterpart of the JAX package's runtime/sensevoice_asr.py. Role of the
SenseVoice paths in sensevoice-small.cpp: the offline forward with
language/textnorm meta ids (:596-642), greedy CTC (:323-377) or the
context-graph-biased prefix beam (:392-440). It has the recognize/recognize_batch and
dispatch_batch/finish_batch interface of ParaformerOffline, so it drops
into OfflineRecognizer, TwoPassSession and the engine's pass-2 lane.

What reaches the host: greedy runs on the device (models/sensevoice.
greedy_ids), so a greedy item fetches [B, U] ids, counts and [B, 4] meta.
A beam item also fetches the device-pruned [B, T, 64] candidate ids and
log-probs (parallel/ctc_shard.py) plus the [B, T, E] log-probs of its
context graph's unit ids, force-included so the prune never hides a
hotword unit from the bias. An item with an LM decoder (TLG rescoring,
the reference's BeamSearch path, sensevoice-small.cpp:442-494) fetches
its frames' log-softmax rows gathered on the device to its graph's input
labels: [T, labels], where the JAX package fetches the whole [B, T, V]
logits. No path fetches those. All of a call's outputs come back in one
copy. The beam and the TLG search run on the host in the native library
(native/src/ctc_beam.cc, tlg_decoder.cc), which releases the interpreter
lock while it decodes.

With tp_mesh (a DeviceMesh with a "tp" axis; every rank constructs the
recognizer and calls it with the same arguments, and gets the whole
result list) the model is sharded over tp (parallel/sharding), each
rank's CTC head holding V/tp columns, and the logits stay sharded: the
greedy ids come from each rank's column maxima ([B, T] exchanged), the
beam's first prune runs sharded (ctc_first_prune_sharded[_gather]), so
only [B, T, k] candidates and the context units' log-probs, normalised
over the whole vocab, are exchanged. Only an LM item's rows gather the
whole vocab. A "dp" axis of the mesh holds copies: each runs the whole
batch. A server hands every recognizer the rank's one shard
(presharded=True), and its rank 0 sets `fanout` (server/fanout.py),
through which dispatch_batch and forward_feats reach the other ranks.

The TLG search is frame-synchronous over CTC rows, so it needs a graph
with the CTC topology (tools/build_tlg.py --ctc-blank): a decoder of any
other kind, or over a graph without the blank unit, raises ValueError
instead of decoding garbage.

Spans and counters (runtime/metrics) as in ParaformerOffline:
asr.frontend, asr.forward, asr.fetch, asr.finish; asr.frames and
asr.frames_padded.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import SenseVoiceConfig
from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.decode.ctc import ctc_prefix_beam_search_pruned
from asr2pass_tpu_torch.decode.tlg import TlgDecoder
from asr2pass_tpu_torch.frontend.fbank import num_frames
from asr2pass_tpu_torch.frontend.lfr import lfr_len
from asr2pass_tpu_torch.models import sensevoice
from asr2pass_tpu_torch.models.sensevoice import NUM_META
from asr2pass_tpu_torch.parallel.ctc_shard import (
    ctc_first_prune, ctc_first_prune_gather, ctc_first_prune_sharded,
    ctc_first_prune_sharded_gather)
from asr2pass_tpu_torch.parallel.sharding import check_sharded, shard_params
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.runtime.offline_asr import (_MAX_BATCH,
                                                    _batch_bucket, _bucket)
from asr2pass_tpu_torch.runtime.streaming_frontend import offline_frontend_device
from asr2pass_tpu_torch.text.vocab import Vocab
from asr2pass_tpu_torch.utils import fp32_products, resolve_device, to_host

_KCAND = 64              # device first-prune width (beam mode)


def context_unit_ids(context: Optional[ContextGraph], token2id
                     ) -> List[int]:
    """Every vocab id reachable in a context graph's trie: the id set
    force-included into the pruned beam's candidates."""
    if context is None:
        return []
    ids, stack = set(), [context.root]
    while stack:
        node = stack.pop()
        for tok, child in node.children.items():
            tid = token2id.get(tok)
            if tid is not None:
                ids.add(int(tid))
            stack.append(child)
    return sorted(ids)


class SenseVoiceOffline:
    """params: a SenseVoice module, or its state dict (as
    model_zoo.load_svs_bundle returns it). The model runs on `device`
    (default the card; device="cpu" for the plain PyTorch path).
    lm_decoder: a TlgDecoder over a CTC-topology graph, for every item
    without one of its own in recognize_batch's lm_decoders. tp_mesh:
    see the module's docstring; presharded: params is already this
    rank's shard over tp_mesh, used as it is."""

    fanout = None

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: SenseVoiceConfig, vocab: Vocab, cmvn=None,
                 lang: str = "auto", use_itn_token: bool = True,
                 context: Optional[ContextGraph] = None, beam: int = 0,
                 lm_decoder=None, device="cuda", tp_mesh=None,
                 presharded: bool = False):
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.model = params.to(self.device).eval().requires_grad_(False)
        else:
            self.model = sensevoice.from_state_dict(params, cfg, self.device)
        self.tp_mesh = tp_mesh
        if presharded:
            check_sharded(self.model, tp_mesh)
        elif tp_mesh is not None:
            self.model = shard_params(self.model, tp_mesh)
        self.cfg = cfg
        self.vocab = vocab
        self.cmvn = cmvn if cmvn is not None else (None, None)
        self.lang = lang
        self.use_itn_token = use_itn_token
        self.context = context
        self.beam = beam
        self.lm_decoder = self._check_lm(lm_decoder)
        # bytes of LM rows copied to the host, over the recognizer's life
        self.lm_bytes_copied = 0

    def _check_lm(self, lm):
        """lm, when it can decode this model's CTC frames: a TlgDecoder
        over a graph with the blank unit; raises ValueError otherwise."""
        if lm is None:
            return lm
        blank = self.vocab.id2token(self.cfg.blank_id)
        if not isinstance(lm, TlgDecoder):
            raise ValueError(f"SenseVoice rescoring takes a TlgDecoder over "
                             f"a CTC graph, not {type(lm).__name__}")
        if not lm.graph.is_ctc(blank):
            raise ValueError(
                f"the TLG graph {lm.graph.graph_dir} has no {blank!r} "
                "unit: SenseVoice needs the CTC topology of build_tlg "
                "--ctc-blank")
        return lm

    def set_lang(self, lang: str):
        self.lang = lang

    def _meta_ids(self, n: int):
        lid = self.cfg.lid_dict.get(self.lang, self.cfg.lid_dict["auto"])
        tn = (self.cfg.textnorm_dict["withitn"] if self.use_itn_token
              else self.cfg.textnorm_dict["woitn"])
        return np.full(n, lid, np.int64), np.full(n, tn, np.int64)

    def _ctx_for(self, contexts, i) -> Optional[ContextGraph]:
        if contexts is not None and contexts[i] is not None:
            return contexts[i]
        return self.context

    def _item_units(self, contexts, i) -> Optional[List[int]]:
        """Segment i's context unit ids, or None without a context."""
        ctx = self._ctx_for(contexts, i)
        return (None if ctx is None
                else context_unit_ids(ctx, self.vocab.token2id))

    def _forward(self, feats: torch.Tensor, lengths: List[int],
                 lid=None, tn=None):
        """One forward over a padded chunk: feats [B, T, lfr_dim],
        lengths [B] (0 for a padding row); lid/tn [B] meta ids (the
        recognizer's own when None)."""
        b = feats.shape[0]
        if lid is None:
            lid, tn = self._meta_ids(b)
        as_long = lambda x: torch.as_tensor(np.asarray(x, np.int64),
                                            device=self.device)
        return sensevoice.apply(self.model, self.cfg, feats, as_long(lengths),
                                as_long(lid), as_long(tn))

    def dispatch_batch(self, segments: List[np.ndarray], hw_emb=None,
                       langs: Optional[List[Optional[str]]] = None,
                       itn_flags: Optional[List[Optional[bool]]] = None,
                       contexts: Optional[List] = None,
                       lm_decoders: Optional[List] = None,
                       feats_override=None):
        """Phase A: front-end and forward on the device. Returns
        (pending, handles); `handles` are the device tensors finish_batch
        needs. feats_override as in ParaformerOffline.dispatch_batch.
        lm_decoders[i]: segment i's TlgDecoder, or None for the
        recognizer's.

        `hw_emb` is accepted for ParaformerOffline's interface and has no
        meaning here: SenseVoice hotword biasing is the context graph in
        the CTC beam (sensevoice-small.cpp:392-440), given per segment
        in `contexts` or to the recognizer as `context`. With a fan-out,
        on every rank of the server."""
        kw = dict(hw_emb=hw_emb, langs=langs, itn_flags=itn_flags,
                  contexts=contexts, lm_decoders=lm_decoders,
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
    def _dispatch(self, segments, hw_emb=None, langs=None, itn_flags=None,
                  contexts=None, lm_decoders=None, feats_override=None,
                  lm_flags=None, unit_ids=None):
        """dispatch_batch on this rank. A worker rank's call gives, in
        place of the decoders and graphs rank 0 holds, lm_flags[i]
        (segment i has an LM decoder: its chunk gathers the vocab; this
        rank computes no LM rows) and unit_ids[i] (its context unit ids,
        or None without a context)."""
        means, vars_ = self.cmvn
        fcfg = self.cfg.frontend
        bufs = [np.asarray(s, np.float32) for s in segments]
        ns = [num_frames(len(b), fcfg) for b in bufs]
        t_lfrs = [lfr_len(n, fcfg.lfr_m, fcfg.lfr_n) if n else 0
                  for n in ns]
        lms = [self._check_lm(lm_decoders[i]) if lm_decoders is not None
               and lm_decoders[i] is not None else self.lm_decoder
               for i in range(len(bufs))]
        has_lm = ([lm is not None for lm in lms] if lm_flags is None
                  else [bool(x) for x in lm_flags])
        units = (list(unit_ids) if unit_ids is not None
                 else [self._item_units(contexts, i)
                       for i in range(len(bufs))])
        results: List[Optional[Tuple[str, list]]] = [None] * len(bufs)
        metas: List[Optional[List[int]]] = [None] * len(bufs)
        groups = {}
        for i, t in enumerate(t_lfrs):
            if t == 0:
                results[i] = ("", [])
                continue
            groups.setdefault(_bucket(t), []).append(i)
        chunks = [(bucket, idxs[j: j + _MAX_BATCH])
                  for bucket, idxs in groups.items()
                  for j in range(0, len(idxs), _MAX_BATCH)]
        records = []
        handles: list = []
        for bucket, idxs in chunks:
            bb = _batch_bucket(len(idxs))
            lens = [0] * bb
            for k, i in enumerate(idxs):
                lens[k] = t_lfrs[i]
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
            lid, tn = self._meta_ids(bb)
            for k, i in enumerate(idxs):
                if langs is not None and langs[i] is not None:
                    lid[k] = self.cfg.lid_dict.get(
                        langs[i], self.cfg.lid_dict["auto"])
                if itn_flags is not None and itn_flags[i] is not None:
                    tn[k] = (self.cfg.textnorm_dict["withitn"]
                             if itn_flags[i]
                             else self.cfg.textnorm_dict["woitn"])
            with METRICS.stage("asr.forward"):
                out = self._forward(feats, lens, lid, tn)
            ids, counts, meta = sensevoice.greedy_ids(
                out, blank_id=self.cfg.blank_id)
            hlist = [ids, counts, meta, out.lengths]
            # an LM item's frames (meta rows stripped): log-softmax and
            # the graph's gather on the device
            logits = (sensevoice.whole_logits(out)
                      if any(has_lm[i] for i in idxs) else None)
            lm_ks = [k for k, i in enumerate(idxs) if lms[i] is not None]
            for k in lm_ks:
                lp = torch.log_softmax(
                    logits[k, NUM_META: NUM_META + lens[k]].float(), -1)
                hlist.append(lms[idxs[k]].graph.gather_rows(lp))
            beam_items = [i for i in idxs if not has_lm[i]
                          and (self.beam > 1 or units[i] is not None)]
            hw_ids: List[int] = []
            if beam_items:
                # force-include every context unit id so the top-k prune
                # can never hide a hotword unit from the bias (the
                # reference biases the full-vocab beam,
                # ctc-prefix-decoder.cpp:280-299)
                uniq = set()
                for i in beam_items:
                    uniq.update(units[i] or ())
                hw_ids = sorted(uniq)
                padded = None
                if hw_ids:
                    # padded to a power of two, as the JAX package pads
                    # to bound its programs: the gather's width is the
                    # same set of shapes on both
                    e = 1
                    while e < len(hw_ids):
                        e *= 2
                    padded = hw_ids + [hw_ids[0]] * (e - len(hw_ids))
                if self.tp_mesh is not None and padded is not None:
                    hlist.extend(ctc_first_prune_sharded_gather(
                        out.logits, padded, self.tp_mesh, "tp", k=_KCAND))
                elif self.tp_mesh is not None:
                    hlist.extend(ctc_first_prune_sharded(
                        out.logits, self.tp_mesh, "tp", k=_KCAND))
                elif padded is not None:
                    hlist.extend(ctc_first_prune_gather(out.logits, padded,
                                                        k=_KCAND))
                else:
                    hlist.extend(ctc_first_prune(out.logits, k=_KCAND))
            records.append({"idxs": idxs, "beam": bool(beam_items),
                            "hw_ids": hw_ids, "lm_ks": lm_ks,
                            "off": len(handles), "n": len(hlist)})
            handles.extend(hlist)
        pending = {"records": records, "results": results, "metas": metas,
                   "contexts": contexts, "lms": lms}
        return pending, handles

    def finish_batch(self, pending, fetched, with_meta: bool = False):
        """Phase B: host decode over the fetched (numpy) arrays: greedy
        straight from the device-collapsed ids; beam items run the pruned
        prefix beam with their context graph."""
        with METRICS.stage("asr.finish"):
            return self._finish(pending, fetched, with_meta)

    def _finish(self, pending, fetched, with_meta):
        results = pending["results"]
        metas = pending["metas"]
        contexts = pending["contexts"]
        lms = pending["lms"]
        for rec in pending["records"]:
            idxs = rec["idxs"]
            vals = list(fetched[rec["off"]: rec["off"] + rec["n"]])
            ids, counts, meta, lengths = (np.asarray(vals.pop(0))
                                          for _ in range(4))
            lm_rows = {k: vals.pop(0) for k in rec["lm_ks"]}
            self.lm_bytes_copied += sum(r.nbytes for r in lm_rows.values())
            cid = clp = hw_lp = None
            if rec["beam"]:
                cid = np.asarray(vals.pop(0))
                clp = np.asarray(vals.pop(0), np.float32)
                if rec["hw_ids"]:
                    hw_lp = np.asarray(vals.pop(0), np.float32)
            for k, i in enumerate(idxs):
                ctx = self._ctx_for(contexts, i)
                # the meta positions' argmax (lang, emotion, event,
                # textnorm: what CTCSearch strips,
                # sensevoice-small.cpp:323-377), returned per segment
                metas[i] = [int(x) for x in meta[k]]
                if k in lm_rows:
                    # the frame-synchronous search over the CTC rows; the
                    # graph's T layer absorbs blanks and repeats
                    lms[i].start_utterance()
                    results[i] = (lms[i].decode_ilabel_rows(lm_rows[k]), [])
                    continue
                if self.beam > 1 or ctx is not None:
                    ln = int(lengths[k])
                    fid = cid[k, NUM_META:ln]
                    flp = clp[k, NUM_META:ln]
                    if rec["hw_ids"]:
                        fid, flp = _merge_candidates(
                            fid, flp, rec["hw_ids"],
                            hw_lp[k, NUM_META:ln])
                    nbest = ctc_prefix_beam_search_pruned(
                        fid, flp, ln - NUM_META,
                        beam=max(self.beam, 10),
                        blank_id=self.cfg.blank_id, context=ctx,
                        id_to_token=self.vocab.id2token,
                        token2id=self.vocab.token2id)
                    tok_ids = nbest[0][0] if nbest else []
                else:
                    tok_ids = [int(x) for x in ids[k, : int(counts[k])]]
                results[i] = (self.vocab.to_string(tok_ids), [])
        out = [r if r is not None else ("", []) for r in results]
        if with_meta:
            return [(t, s, m) for (t, s), m in zip(out, metas)]
        return out

    def recognize_batch(self, segments: List[np.ndarray], hw_emb=None,
                        langs: Optional[List[Optional[str]]] = None,
                        itn_flags: Optional[List[Optional[bool]]] = None,
                        contexts: Optional[List] = None,
                        lm_decoders: Optional[List] = None,
                        feats_override=None,
                        with_meta: bool = False
                        ) -> List[Tuple[str, list]]:
        """langs[i], itn_flags[i] and contexts[i] override the
        recognizer's lang, use_itn_token and context for segment i: the
        engine's pass-2 lane mixes connections with different first-
        message options in one batch (the lid/textnorm prefix inputs,
        sensevoice-small.cpp:596-642). with_meta=True appends each
        segment's [lid, emotion, event, textnorm] argmax ids to its
        result tuple. lm_decoders[i]: segment i's TlgDecoder (a
        connection's, with its hotwords), or None for the recognizer's."""
        pending, handles = self.dispatch_batch(
            segments, hw_emb=hw_emb, langs=langs, itn_flags=itn_flags,
            contexts=contexts, lm_decoders=lm_decoders,
            feats_override=feats_override)
        if handles:
            with METRICS.stage("asr.fetch"):
                handles = to_host(handles)
        return self.finish_batch(pending, handles, with_meta=with_meta)

    def recognize(self, samples: np.ndarray, hw_emb=None
                  ) -> Tuple[str, list]:
        return self.recognize_batch([samples], hw_emb)[0]


def _merge_candidates(cid: np.ndarray, clp: np.ndarray,
                      hw_ids: List[int], hw_lp: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Append the context unit ids (and their true log-probs) to each
    frame's pruned candidate set, masking entries the top-k already holds
    so the prefix beam never counts a token's probability twice."""
    t, _ = cid.shape
    e = len(hw_ids)
    ids_arr = np.asarray(hw_ids, np.int32)
    out_ids = np.concatenate(
        [cid, np.broadcast_to(ids_arr, (t, e)).copy()], axis=1)
    extra = hw_lp[:, :e].copy()
    dup = (cid[:, :, None] == ids_arr[None, None, :]).any(axis=1)
    extra[dup] = -1e30    # dropped by the beam's low-prob gate
    out_lp = np.concatenate([clp, extra], axis=1)
    return out_ids, out_lp
