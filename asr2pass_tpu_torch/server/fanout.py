"""Serving on several cards: rank 0's pass-2 calls fanned out to the
worker ranks.

The JAX package has no counterpart: there one process drives every
device, GSPMD issues the collectives, and the server's threads just call
the recognizer. The port runs one process a card, and a sharded module's
collectives are matched by issue order, so every rank must make the same
device calls in the same order (parallel/multihost.py). A server breaks
that rule twice: only rank 0 receives requests, and rank 0 calls pass 2
from several threads (the decode and upload executors, the engine's
pass-2 lane, the warm-ups). So:

  rank 0        every pass-2 call of a recognizer that ServerModels built
                over its tp or sp mesh (the recognizer's `fanout` set)
                goes through Fanout.dispatch or Fanout.forward, which
                hold one lock while they send the call to the other ranks
                and make it: every rank sees the calls in one order, and
                two calls never interleave their collectives
  ranks 1..N-1  serve_worker(models) receives each call and makes the
                same device calls on its own recognizer (its shard of the
                same module), issuing the same collectives; it finishes
                nothing and returns on rank 0's stop message (stop())

What decides a call's collectives, and so what it carries:

  ParaformerOffline.dispatch_batch  the TP forward of each chunk (chunks
      by the items' feature lengths and hotword counts: the samples, or
      their lengths, and the hotword embeddings); _record's all_gather
      over dp of the handles, and of the logits where an item has an LM
      (one flag an item); under sp_mesh alone the sequence-parallel
      encoder of the segments past sp_threshold (only those are sent;
      the rest run on rank 0 alone); under both meshes the whole call,
      with the SP segments' samples where the TP chunks' features are
      broadcast
  SenseVoiceOffline.dispatch_batch  the TP forward (chunks by length; each
      item's language and ITN flag are inputs of the forward), the greedy
      ids' all_gathers, whole_logits where an item of the chunk has an LM
      (the flags), and the sharded prune of the beam and context items
      (the beam width, each item's context unit ids in place of its
      graph)
  host only (rank 0)  finish_batch: detokenization, the LM, TLG and
      context beam searches, timestamps; punctuation, ITN; the hotword
      compile (the hotword model is not sharded)

A call with a feats_override (the engine's ring gather) carries no
samples: rank 0 gathers each chunk's features from its ring (or computes
them from the samples where the ring no longer holds them) and
broadcasts the tensor card to card. A call without one carries the
segments' float32 samples, and every rank runs its own front-end.

Calls travel pickled over a gloo group of the same ranks
(comm.broadcast_object), feature tensors over the default group (NCCL on
the card). While idle, rank 0 sends a ping every timeout / 4, so the
workers' wait for the next call never reaches the group's timeout and a
worker learns of a lost rank 0 within it.

Faults. Inputs are checked before a call goes out: a bad one raises on
rank 0 and the group stays usable. A failure after it leaves the ranks at
different places in the collective sequence: rank 0 prints the error and
exits with FAULT_EXIT; the workers' next collective then fails (gloo: the
peer is gone; NCCL: init_distributed's timeout_s) and they exit non-zero
too. A worker's own failure ends its process, and the launcher's rank 0
exits when one of its workers ends (server/run_server.py).
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from asr2pass_tpu_torch.frontend.fbank import num_frames
from asr2pass_tpu_torch.frontend.lfr import lfr_len
from asr2pass_tpu_torch.parallel import comm
from asr2pass_tpu_torch.parallel.multihost import group_timeout_s
from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
from asr2pass_tpu_torch.runtime.streaming_frontend import \
    offline_frontend_device

log = logging.getLogger("asr2pass.fanout")

FAULT_EXIT = 70          # rank 0's exit code after a failure past a send
_ROOT = 0


def _pct(xs: List[float], q: float) -> Optional[float]:
    return float(np.percentile(xs, q)) if xs else None


class Fanout:
    """The fan-out of one server's ranks (every rank of the default
    group). Built on every rank, in the same order as the other
    collectives (it makes a gloo group): ServerModels does it when it has
    a tp or sp mesh. On rank 0 (`root`) the recognizers call dispatch and
    forward; the other ranks call serve_worker."""

    def __init__(self):
        # the group's own timeout (init_distributed's timeout_s)
        self.timeout_s = float(group_timeout_s() or 300.0)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.root = self.rank == _ROOT
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=self.timeout_s))
        self.lock = threading.Lock()
        # the counters' own lock: stats() never waits on a call
        self._stats_lock = threading.Lock()
        self._stopped = False
        self._last_send = time.monotonic()
        self.calls = self.broadcasts = self.bytes = self.pings = 0
        self.call_broadcasts: List[int] = []
        self.call_bytes: List[int] = []
        self.lock_wait_s: List[float] = []
        self._ping_thread = None
        if self.root and self.world > 1:
            self._ping_thread = threading.Thread(
                target=self._pinger, daemon=True, name="fanout-ping")
            self._ping_thread.start()

    # -- rank 0 ----------------------------------------------------------
    def dispatch(self, rec, segments, **kw):
        """rec.dispatch_batch(segments, **kw) on every rank: the call
        sent, then made, under the lock (rec is a ParaformerOffline or a
        SenseVoiceOffline whose `fanout` is this)."""
        call, sp_only = self._dispatch_call(rec, segments, kw)
        if call is None:
            # a sequence-parallel recognizer's call with no segment past
            # its threshold: nothing runs on the other ranks
            return rec._dispatch(segments, **kw)
        if not sp_only and kw.get("feats_override") is not None:
            kw["feats_override"] = self._feats_sender(
                rec, segments, kw["feats_override"])
        with self._held():
            try:
                self._send(call)
                return rec._dispatch(segments, **kw)
            except BaseException:
                self._fault("a pass-2 call")

    def forward(self, rec, feats: torch.Tensor, lengths: List[int]):
        """rec._forward(feats, lengths) on every rank, feats broadcast (the
        engine's warm-up forward). A sequence-parallel recognizer's plain
        forward issues no collective and runs on rank 0 alone."""
        if rec.tp_mesh is None:
            return rec._forward(feats, list(lengths))
        feats = feats.float().contiguous()
        call = {"op": "forward", "role": _role(rec), "sp": False,
                "shape": list(feats.shape),
                "lengths": [int(x) for x in lengths]}
        with self._held():
            try:
                self._send(call)
                self._broadcast_feats(feats)
                return rec._forward(feats, list(lengths))
            except BaseException:
                self._fault("a pass-2 forward")

    def stop(self, timeout_s: Optional[float] = None) -> bool:
        """Send the workers their stop message (once). False when a call
        held the lock past timeout_s (the group's timeout by default)."""
        if not self.root or self._stopped:
            return True
        if not self.lock.acquire(timeout=timeout_s or self.timeout_s):
            return False
        try:
            if not self._stopped:
                self._send({"op": "stop"})
                self._stopped = True
        finally:
            self.lock.release()
        return True

    def stats(self) -> dict:
        """Calls sent, their broadcasts and bytes (each and in all), the
        lock's wait (ms), pings. Takes only the counters' lock, never
        the one a pass-2 call holds."""
        with self._stats_lock:
            waits = [w * 1e3 for w in self.lock_wait_s]
            return {
                "rank": self.rank, "world": self.world, "calls": self.calls,
                "broadcasts": self.broadcasts, "bytes": self.bytes,
                "pings": self.pings,
                "broadcasts_a_call": {
                    "p50": _pct(self.call_broadcasts, 50),
                    "max": max(self.call_broadcasts, default=None)},
                "bytes_a_call": {"p50": _pct(self.call_bytes, 50),
                                 "p95": _pct(self.call_bytes, 95),
                                 "max": max(self.call_bytes, default=None)},
                "lock_wait_ms": {"p50": _pct(waits, 50),
                                 "p95": _pct(waits, 95),
                                 "max": max(waits, default=None)}}

    def _dispatch_call(self, rec, segments, kw):
        """(the call's message, whether it is a sequence-parallel one), or
        (None, True) when nothing of it runs on the other ranks. Checks
        every input the message carries: a bad one raises here, before
        anything is sent."""
        if self._stopped:
            raise RuntimeError("the fan-out has stopped")
        bufs = [np.asarray(s, np.float32) for s in segments]
        for b in bufs:
            if b.ndim != 1:
                raise ValueError(f"a segment of shape {b.shape}: pass-2 "
                                 "takes 1-D samples")
        n = len(bufs)
        lm_decoders = _per_item(kw.get("lm_decoders"), n, "lm_decoders")
        call = {"op": "dispatch", "role": _role(rec), "sp": False}
        if isinstance(rec, SenseVoiceOffline):
            langs = _per_item(kw.get("langs"), n, "langs")
            itn = _per_item(kw.get("itn_flags"), n, "itn_flags")
            contexts = _per_item(kw.get("contexts"), n, "contexts")
            lms = [rec._check_lm(lm) if lm is not None else rec.lm_decoder
                   for lm in lm_decoders]
            call.update(
                langs=[str(x) if x is not None else rec.lang for x in langs],
                itn=[bool(x) if x is not None else rec.use_itn_token
                     for x in itn],
                lm=[lm is not None for lm in lms],
                units=[rec._item_units(contexts, i) for i in range(n)],
                beam=int(rec.beam))
        else:
            hw_embs = kw.get("hw_embs")
            if hw_embs is None:
                hw_embs = [kw.get("hw_emb")] * n
            hw_embs = [None if h is None else np.asarray(h, np.float32)
                       for h in _per_item(hw_embs, n, "hw_embs")]
            for h in hw_embs:
                if h is not None and h.ndim != 2:
                    raise ValueError(f"hotword embeddings of shape "
                                     f"{h.shape}: [N, D] expected")
            call.update(hw=hw_embs,
                        lm=[(lm if lm is not None else rec.lm_decoder)
                            is not None for lm in lm_decoders])
            long = []
            if rec.sp_mesh is not None:
                fcfg = rec.cfg.frontend
                long = [i for i, b in enumerate(bufs)
                        if lfr_len(num_frames(len(b), fcfg), fcfg.lfr_m,
                                   fcfg.lfr_n) > rec.sp_threshold]
                call["sp"] = True
            if rec.sp_mesh is not None and rec.tp_mesh is None:
                if not long:
                    return None, True
                # the SP groups alone: they decode without hotwords or
                # LM rows, so only their samples matter to the workers
                call.update(audio=[bufs[i] for i in long],
                            hw=[None] * len(long), lm=[False] * len(long))
                return call, True
            if long and kw.get("feats_override") is not None:
                # a TP and SP recognizer: the SP segments' encoder runs on
                # each rank's own time slice of their features, so their
                # samples travel beside the TP chunks' broadcast features
                call["sp_audio"] = {i: bufs[i] for i in long}
        if kw.get("feats_override") is not None:
            call["lengths"] = [len(b) for b in bufs]
        else:
            call["audio"] = bufs
        return call, False

    def _feats_sender(self, rec, segments, inner):
        """The feats_override rank 0 runs under fan-out: each chunk's
        features from `inner` (the ring), else from the samples, then
        broadcast; never None."""
        fcfg = rec.cfg.frontend
        means, vars_ = rec.cmvn
        bufs = [np.asarray(s, np.float32) for s in segments]

        def send(idxs, bucket, bb):
            feats = inner(idxs, bucket, bb)
            if feats is None:
                feats = offline_frontend_device(
                    [bufs[i] for i in idxs],
                    [num_frames(len(bufs[i]), fcfg) for i in idxs], bucket,
                    fcfg, means, vars_, batch_b=bb, device=rec.device)
            want = (bb, bucket, fcfg.lfr_dim)
            if tuple(feats.shape) != want or feats.dtype != torch.float32:
                raise RuntimeError(f"chunk features {tuple(feats.shape)} "
                                   f"{feats.dtype}, expected {want} fp32")
            feats = feats.contiguous()
            self._broadcast_feats(feats)
            return feats

        return send

    def _broadcast_feats(self, feats: torch.Tensor):
        comm.broadcast(feats, _ROOT, dist.group.WORLD)
        self._count(1, feats.numel() * feats.element_size())

    def _send(self, call: dict):
        _, size = comm.broadcast_object(call, _ROOT, self.group)
        self._last_send = time.monotonic()
        with self._stats_lock:
            if call["op"] == "ping":
                self.pings += 1
                return
            self.calls += 1
            self.call_broadcasts.append(0)
            self.call_bytes.append(0)
        self._count(2, size + 8)

    def _count(self, broadcasts: int, nbytes: int):
        with self._stats_lock:
            self.broadcasts += broadcasts
            self.bytes += nbytes
            if self.call_broadcasts:
                self.call_broadcasts[-1] += broadcasts
                self.call_bytes[-1] += nbytes

    @contextlib.contextmanager
    def _held(self):
        """The lock, its wait recorded."""
        t0 = time.perf_counter()
        with self.lock:
            with self._stats_lock:
                self.lock_wait_s.append(time.perf_counter() - t0)
            if self._stopped:
                raise RuntimeError("the fan-out has stopped")
            yield

    def _pinger(self):
        every = self.timeout_s / 4
        while not self._stopped:
            time.sleep(min(every, 1.0))
            if time.monotonic() - self._last_send < every:
                continue
            with self.lock:
                if self._stopped:
                    return
                if time.monotonic() - self._last_send >= every:
                    try:
                        self._send({"op": "ping"})
                    except BaseException:
                        self._fault("a ping")

    def _fault(self, what: str):
        """A failure while a call goes out or after: the ranks no longer
        agree on the collective sequence. Print it and end this
        process."""
        traceback.print_exc()
        log.critical("fan-out: %s failed after it was sent to the other "
                     "ranks; exiting with %d", what, FAULT_EXIT)
        for h in logging.getLogger().handlers:
            h.flush()
        os._exit(FAULT_EXIT)

    # -- ranks 1..N-1 ----------------------------------------------------
    def receive(self) -> dict:
        call, _ = comm.broadcast_object(None, _ROOT, self.group)
        return call

    def replay(self, rec, call: dict):
        """Make one received call's device calls on this rank's
        recognizer; the outputs are dropped (rank 0 finishes)."""
        with torch.inference_mode():
            if call["op"] == "forward":
                feats = torch.empty(call["shape"], dtype=torch.float32,
                                    device=rec.device)
                comm.broadcast(feats, _ROOT, dist.group.WORLD)
                rec._forward(feats, call["lengths"])
                return
            override = None
            if "audio" in call:
                segs = call["audio"]
            else:
                segs = [np.broadcast_to(np.float32(0), (n,))
                        for n in call["lengths"]]
                for i, samples in call.get("sp_audio", {}).items():
                    segs[i] = samples
                dim = rec.cfg.frontend.lfr_dim

                def override(idxs, bucket, bb):
                    feats = torch.empty((bb, bucket, dim),
                                        dtype=torch.float32,
                                        device=rec.device)
                    return comm.broadcast(feats, _ROOT, dist.group.WORLD)
            if call["role"] == "svs":
                rec.beam = call["beam"]
                rec._dispatch(segs, langs=call["langs"],
                              itn_flags=call["itn"], lm_flags=call["lm"],
                              unit_ids=call["units"],
                              feats_override=override)
            else:
                rec._dispatch(segs, hw_embs=call["hw"], lm_flags=call["lm"],
                              feats_override=override)


def _role(rec) -> str:
    return "svs" if isinstance(rec, SenseVoiceOffline) else "asr"


def _per_item(values, n: int, what: str) -> list:
    if values is None:
        return [None] * n
    values = list(values)
    if len(values) != n:
        raise ValueError(f"{what}: {len(values)} entries for {n} segments")
    return values


def serve_worker(models) -> None:
    """A worker rank's loop: receive rank 0's pass-2 calls and make them on
    this rank's recognizers (one for each role and sequence-parallel
    flag, built at first use from `models`, a ServerModels made with the
    same arguments as rank 0's), until rank 0's stop message. An error
    ends the loop by raising: the process must exit non-zero."""
    fan = models.fanout
    if fan is None or fan.root:
        raise ValueError("serve_worker runs on a rank > 0 of a ServerModels "
                         "with a tp or sp mesh")
    recs = {}
    while True:
        call = fan.receive()
        if call["op"] == "stop":
            return
        if call["op"] == "ping":
            continue
        key = (call["role"], call["sp"])
        if key not in recs:
            recs[key] = models.worker_recognizer(*key)
        fan.replay(recs[key], call)
