"""The 2pass family: the websocket service as the launcher builds it
(server/run_server.build_models on model directories written by the
program's model_zoo, AsrWsServer with the StreamEngine): streaming
Paraformer-large-online as pass 1, Paraformer-large as pass 2, the
FSMN-VAD and the CT-Transformer's streaming punctuation; and its
comparison with the plain references (benchmark/reference/online.py for
the VAD fed the engine's windows, the splitter and pass 1; nets.py for
pass 2 and punctuation).

What the window served is recorded by hooks on the engine, on the host
data the engine has anyway: the audio each tick handed the VAD, each
pass-1 step's chunk counts, final flags and fired ids (device tensors
kept as they are and fetched once, after the window), each pass-2
segment with the ids finish_batch fetched, and each punctuation window.
The callers record what came back to them.
"""
from __future__ import annotations

import asyncio
import copy
import dataclasses
import gc
import os
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.families import common, paraformer
from benchmark.lib import attn, flops, serving, weights
from benchmark.reference import config as ref_config
from benchmark.reference import frontend, nets, online, text
from benchmark.traffic import bulk_files

CALIBRATION_SEED = 20260418
# the engine's stages whose samples the window keeps
STAGES = ("tick", "tick_p1_dispatch", "p2_recognize")


def online_cfg(mod, node: dict):
    """Pass 1: the configuration file's "asr", with its chunk."""
    return dataclasses.replace(paraformer.asr_cfg(mod, node),
                               chunk_size=tuple(node["chunk_size"]))


def pass2_node(node: dict) -> dict:
    """The paraformer family's configuration of pass 2: the file's "asr"
    with the "pass2" changes (groups replaced key by key)."""
    out = copy.deepcopy(node)
    asr = out["asr"]
    for key, val in node["pass2"].items():
        if key == "source":
            continue
        if isinstance(val, dict):
            asr[key] = dict(asr[key], **val)
        else:
            asr[key] = val
    asr.pop("chunk_size", None)
    return out


class ThreadCalls(attn.Calls):
    """attn.Calls with the decoder's token mask kept per thread. The
    engine's pass-2 lane runs the offline decoder while the tick thread
    runs pass 1's attention: one mask for both would pair one thread's
    queries with another's keys."""

    def __init__(self):
        self._local = threading.local()
        super().__init__()

    @property
    def q_mask(self):
        return getattr(self._local, "q_mask", None)

    @q_mask.setter
    def q_mask(self, mask):
        self._local.q_mask = mask


class Service:
    """The running server: its port, the server and engine objects, the
    recorder on them, and the event loop thread that serves."""

    def __init__(self, server, srv, loop, thread, recorder):
        self.server, self.srv, self.loop = server, srv, loop
        self.thread, self.recorder = thread, recorder
        self.engine = server.engine
        self.port = srv.sockets[0].getsockname()[1]

    def stop(self):
        async def close():
            self.srv.close()
            await self.srv.wait_closed()
            task = getattr(self.server, "_engine_task", None)
            if task is not None:
                task.cancel()

        try:
            asyncio.run_coroutine_threadsafe(close(), self.loop).result(60)
        finally:
            self.engine.shutdown()
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)


class Recorder:
    """Hooks on the engine and the metrics (see the module's docstring).
    Keys of a stream: (engine slot, the slot's generation), which the
    server's connection record names too."""

    def __init__(self, engine, cfg1, cfg2, vcfg, pcfg):
        from asr2pass_tpu_torch.runtime.metrics import GLOBAL

        self.engine = engine
        self.metrics = GLOBAL
        self.cfg1, self.cfg2, self.vcfg, self.pcfg = cfg1, cfg2, vcfg, pcfg
        self.vad: Dict[tuple, list] = {}
        self.vad_rows: List[tuple] = []
        self.steps: List[tuple] = []
        self.fetched = None
        self.segs: Dict[tuple, list] = {}
        self.seg_log: List[tuple] = []
        self.punc_log: List[tuple] = []
        self.stages: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}
        self.report: Dict[str, list] = {}
        self.t_open = self.t_close = None
        self._pairs = None
        self._punc_rec = None
        self._install()

    # -- hooks ---------------------------------------------------------
    def _install(self):
        eng = self.engine
        dispatch, step = eng._vad_dispatch_staged, eng._p1_step
        process = eng._process_segments
        asr, punc = eng.offline.asr, eng.punc
        finish, add_punc, infer = (asr.finish_batch, punc.add_punc_streaming,
                                   punc._infer)
        add_stage = self.metrics.add_stage

        def vad_dispatch(staged):
            t = time.perf_counter()
            rows = 0
            for sid, slot, samples, final, n in staged["work"]:
                self.vad.setdefault((sid, slot.gen), []).append(
                    (len(samples), bool(final)))
                rows += n
            self.vad_rows.append((t, rows))
            return dispatch(staged)

        def p1_step(*a):
            out = step(*a)
            # chunk counts, final flags (the step's inputs) and the fired
            # ids and counts, as device tensors: nothing is copied here
            self.steps.append((time.perf_counter(),
                               [s.gen for s in eng.slots], a[13], a[14],
                               out[1], out[2]))
            return out

        def process_segments(pairs, settled=None):
            t = time.perf_counter()
            recs = []
            for sid, slot, fr in pairs:
                rec = {"slot": slot, "gs": fr.global_start,
                       "ge": fr.global_end, "n": len(fr.data), "t": t,
                       "ids": None, "windows": [], "text": None}
                self.segs.setdefault((sid, slot.gen), []).append(rec)
                recs.append(rec)
            self._pairs = recs
            try:
                return process(pairs, settled)
            finally:
                self._pairs = None

        def finish_batch(pending, fetched, *a, **kw):
            if self._pairs is not None:
                for rec in pending["records"]:
                    arrays = [np.asarray(x) for x in
                              fetched[rec["off"]: rec["off"] + rec["n"]]]
                    ids, counts = arrays[:2]
                    for k, i in enumerate(rec["idxs"]):
                        c = int(counts[k])
                        seg = self._pairs[i]
                        seg.update(ids=ids[k, :c].copy(), cap=ids.shape[1],
                                   frames=int(rec["lens"][k]))
                        self.seg_log.append((seg["t"], seg["frames"], c))
            return finish(pending, fetched, *a, **kw)

        def add_punc_streaming(text_in, cache):
            recs = [r for r in (self._pairs or [])
                    if r["slot"].punc_cache is cache and r["text"] is None]
            self._punc_rec = recs[0] if recs else None
            if self._punc_rec is not None:
                self._punc_rec["text"] = text_in
            try:
                return add_punc(text_in, cache)
            finally:
                self._punc_rec = None

        def _infer(ids, cache_size=0):
            out = infer(ids, cache_size)
            self.punc_log.append((time.perf_counter(), len(ids)))
            if self._punc_rec is not None:
                self._punc_rec["windows"].append((list(ids), cache_size,
                                                  list(out)))
            return out

        def stage(name, dt):
            if (self.t_open is not None and self.t_close is None
                    and name in STAGES):
                self.stages.setdefault(name, []).append(dt)
            return add_stage(name, dt)

        eng._vad_dispatch_staged, eng._p1_step = vad_dispatch, p1_step
        eng._process_segments = process_segments
        asr.finish_batch = finish_batch
        punc.add_punc_streaming, punc._infer = add_punc_streaming, _infer
        self.metrics.add_stage = stage

    def remove(self):
        """The metrics' own add_stage again (the engine goes with the
        server)."""
        del self.metrics.add_stage

    # -- the window ----------------------------------------------------
    def open_window(self, t: float):
        self.t_open, self.t_close = t, None
        self.stages, self.counts = {}, {}
        self.metrics.reset()

    def close_window(self):
        self.t_close = time.perf_counter()
        rep = self.metrics.report()
        self.counts = {k: v for k, v in rep["counts"].items()
                       if k.startswith("engine.")}
        self.report = {k: [v["p50_ms"], v["p95_ms"], v["count"]]
                       for k, v in rep["stages"].items()}
        if self.steps:
            # the one copy of the steps' records, after the window
            cols = [torch.stack([s[i] for s in self.steps]).cpu().numpy()
                    for i in (2, 3, 5)]
            ids = torch.stack([s[4] for s in self.steps]).cpu().numpy()
            self.fetched = (np.array([s[0] for s in self.steps]),
                            np.array([s[1] for s in self.steps]),
                            cols[0], cols[1], cols[2], ids)
        self.steps = []

    def _in_window(self, t) -> bool:
        return self.t_open <= t <= self.t_close

    def _window_rows(self):
        """(new frames, tokens fired) of each row that advanced a stream
        in the window's pass-1 steps."""
        if self.fetched is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        t, _gens, count, final, nums, _ids = self.fetched
        w = (t >= self.t_open) & (t <= self.t_close)
        act = (count[w] > 0) | (final[w] > 0)
        return count[w][act], nums[w][act]

    def p1_rate(self) -> tuple:
        """Tokens pass 1 fired and LFR frames it consumed in the window."""
        count, nums = self._window_rows()
        return int(nums.sum()), int(count.sum())

    def flops(self, window) -> float:
        """The window's useful work: the active rows' pass-1 steps, the
        pass-2 forwards and punctuation windows from their true lengths,
        the VAD rows the streams' audio made."""
        total = flops.fsmn_vad(self.vcfg, sum(
            r for t, r in self.vad_rows if self._in_window(t)))
        for t, frames, u in self.seg_log:
            if self._in_window(t):
                total += flops.paraformer(self.cfg2, frames, u)
        enc = common.punc_encoder(ref_config, self.pcfg)
        for t, n in self.punc_log:
            if self._in_window(t):
                total += flops.ct_transformer(self.pcfg, enc, n)
        count, nums = self._window_rows()
        pairs, times = np.unique(np.stack([count, nums], -1), axis=0,
                                 return_counts=True)
        for (n, u), k in zip(pairs.tolist(), times.tolist()):
            total += k * serving.online_step_flops(self.cfg1, n, u)
        return total

    def calls(self, load, window) -> list:
        """The sampled callers' calls that overlapped the window, whole."""
        out = []
        sampled = set(load.sampled)
        for name, c in window.calls.items():
            r = window.records.get(name)
            if (c["caller"] not in sampled or r is None
                    or r["engine_slot"] is None or c["closed"] < window.t_open
                    or c["opened"] > window.t_close):
                continue
            key = (r["engine_slot"], r["engine_gen"])
            steps = []
            if self.fetched is not None:
                _t, gens, count, final, nums, ids = self.fetched
                sid, gen = key
                for i in np.flatnonzero((gens[:, sid] == gen)
                                        & ((count[:, sid] > 0)
                                           | (final[:, sid] > 0))):
                    k = int(nums[i, sid])
                    steps.append((int(count[i, sid]), bool(final[i, sid]),
                                  ids[i, sid, :k].copy()))
            segs = [{k: v for k, v in s.items() if k != "slot"}
                    for s in self.segs.get(key, [])]
            out.append({"name": name,
                        "audio": load.files[c["pool"]][: c["sent"]],
                        "windows": self.vad.get(key, []), "steps": steps,
                        "segs": segs,
                        "texts": [m[1] for m in c["messages"]
                                  if m[0] == "2pass-offline"]})
        return out


class Family:
    def __init__(self, node: dict):
        self.node = node
        self.cfg1 = online_cfg(ref_config, node["asr"])
        self.p2 = paraformer.Family(pass2_node(node))
        self.cfg2, self.vcfg, self.pcfg = (self.p2.cfg, self.p2.vcfg,
                                           self.p2.pcfg)
        self.tokens, self.ptokens = self.p2.tokens, self.p2.ptokens
        self.weights_s = 0.0
        self.service = None

    # -- weights -------------------------------------------------------
    def weights(self, seed: int, device):
        """Pass 1's state dict, with CIF's output bias set to the
        configuration's firing rate through the streaming windows; pass
        2's, the VAD's and punctuation's as the paraformer family draws
        them."""
        sd1 = weights.make(weights.paraformer(self.cfg1), seed, "online",
                           device)
        self.calibrate(sd1, device)
        return (sd1,) + self.p2.weights(seed, device)

    def calibrate(self, sd, device):
        """Pass 1 fires on random weights at a rate set by chance. The
        bias of the alphas' output is set so that the mean alpha of the
        emitted frames over a fixed 10 s burst, taken in [5, 10, 5]
        chunks through the streaming windows, is the configuration's
        `cif_rate`."""
        g = torch.Generator(device=device)
        g.manual_seed(CALIBRATION_SEED)
        wave = bulk_files.synth(10.0, g, device).float().cpu().numpy()
        means, vars_ = common.cmvn(self.node["cmvn"],
                                   self.cfg1.frontend.lfr_dim)
        cfg = self.cfg1
        p = cfg.predictor
        sd["predictor.out.b"].zero_()
        zs = []
        with torch.inference_mode():
            feats = frontend.offline_feats(wave, cfg.frontend, means, vars_,
                                           device)
            pp = nets.P(sd)
            steps = online.schedule(feats.shape[0], cfg.chunk_size[1])
            for enc, lo, hi in online.windows(pp, cfg, feats, steps):
                h = torch.relu(nets.context_conv(pp("predictor")("conv"), enc,
                                                 p.l_order, p.r_order) + enc)
                zs.append((h @ sd["predictor.out.w"])[lo:hi, 0])
        z = torch.cat(zs).double().cpu().numpy()
        lo, hi = -40.0, 40.0
        for _ in range(80):
            b = (lo + hi) / 2
            a = np.maximum(p.smooth_factor / (1 + np.exp(-(z + b)))
                           - p.noise_threshold, 0.0)
            lo, hi = (b, hi) if a.mean() < self.node["cif_rate"] else (lo, b)
        sd["predictor.out.b"].fill_((lo + hi) / 2)

    # -- the program ---------------------------------------------------
    def build(self, seed: int, device) -> Service:
        """The server as the launcher builds it, on model directories
        written from the seed's weights, started on a free port of
        127.0.0.1 with the engine warmed; the recorder on its engine."""
        from asr2pass_tpu_torch import config as pcfg_mod
        from asr2pass_tpu_torch.runtime import model_zoo
        from asr2pass_tpu_torch.server import run_server, ws_server

        if not hasattr(ws_server.AsrWsServer, "connection_records"):
            raise SystemExit("benchmark: the program's server keeps no "
                             "connection records, which this cell reads")
        # Kineto's CUPTI teardown after a traced window, with the engine's
        # threads launching, has crashed processes (chip_smoke.py)
        os.environ["TEARDOWN_CUPTI"] = "0"
        # a traced window records attention calls from several threads
        attn.Calls = ThreadCalls
        n = self.node
        t0 = time.perf_counter()
        sd1, sd2, sd_vad, sd_punc = self.weights(seed, device)
        self.weights_s = time.perf_counter() - t0
        cmvn = common.cmvn(n["cmvn"], self.cfg1.frontend.lfr_dim)
        eng = n["engine"]
        with tempfile.TemporaryDirectory(prefix="twopass_models_") as tmp:
            d = {k: os.path.join(tmp, k)
                 for k in ("model", "online", "vad", "punc")}
            model_zoo.save_offline_bundle(
                d["model"], sd2, paraformer.asr_cfg(
                    pcfg_mod, pass2_node(n)["asr"]), self.tokens, cmvn)
            model_zoo.save_offline_bundle(
                d["online"], sd1, online_cfg(pcfg_mod, n["asr"]),
                self.tokens, cmvn)
            model_zoo.save_vad_dir(
                d["vad"], sd_vad, common.vad_cfg(pcfg_mod, n["vad"]),
                common.cmvn(n["vad"]["cmvn"], self.vcfg.input_dim))
            model_zoo.save_punc_dir(d["punc"], sd_punc,
                                    common.punc_cfg(pcfg_mod, n["punc"]),
                                    self.ptokens)
            del sd1, sd2, sd_vad, sd_punc
            if device.type == "cuda":
                torch.cuda.empty_cache()
            argv = ["--model-dir", d["model"], "--online-model-dir",
                    d["online"], "--vad-dir", d["vad"], "--punc-dir",
                    d["punc"], "--engine", "--engine-capacity",
                    str(eng["capacity"]), "--host", "127.0.0.1", "--port",
                    "0", "--device", device.type]
            argv += ["--itn"] if n["itn"] else ["--no-itn"]
            argv += ["--upload-overlap"] if eng["upload_overlap"] else []
            argv += ["--decide-async"] if eng["decide_async"] else []
            args = run_server.parser().parse_args(argv)
            models = run_server.build_models(args)
        server = ws_server.AsrWsServer(
            models, host=args.host, port=args.port,
            decode_workers=args.decode_workers, use_engine=args.engine,
            engine_capacity=args.engine_capacity,
            upload_overlap=args.upload_overlap,
            decide_async=args.decide_async,
            max_message_bytes=args.max_message_mb << 20,
            max_upload_bytes=args.max_upload_mb << 20)
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True,
                                  name="ws-server")
        thread.start()
        srv = asyncio.run_coroutine_threadsafe(server.serve(),
                                               loop).result(1800)
        rec = Recorder(server.engine, self.cfg1, self.cfg2, self.vcfg,
                       self.pcfg)
        self.service = Service(server, srv, loop, thread, rec)
        return self.service

    def free(self):
        if self.service is not None:
            self.service.stop()
            self.service.recorder.remove()
            self.service = None
        gc.collect()

    # -- the comparison ------------------------------------------------
    def check(self, calls: list, seed: int, device,
              read: common.Readings):
        """Every sampled call against the plain references."""
        online.float32_products()
        sd1, sd2, sd_vad, sd_punc = self.weights(seed, device)
        for call in calls:
            self._check_call(call, sd1, sd2, sd_vad, sd_punc, device, read)

    def _check_call(self, call, sd1, sd2, sd_vad, sd_punc, device, read):
        n = self.node
        cmvn = common.cmvn(n["cmvn"], self.cfg1.frontend.lfr_dim)
        vcmvn = common.cmvn(n["vad"]["cmvn"], self.vcfg.input_dim)
        audio = call["audio"]
        if sum(k for k, _ in call["windows"]) != len(audio):
            read.worst("vad_off", 1)
            return
        events = online.vad_events(
            sd_vad, self.vcfg, audio, call["windows"], vcmvn,
            self.vcfg.max_end_silence_time,
            self.vcfg.max_single_segment_time, device)
        utts, segs = online.split(audio, call["windows"], events,
                                  self._chunk_len())
        served = [(s["gs"], s["ge"]) for s in call["segs"]]
        if served != [(s, e) for s, e, _ in segs]:
            read.worst("vad_off", 1)
            return
        # pass 1, utterance by utterance, in the engine's chunking
        served_utts, cur = [], []
        for step in call["steps"]:
            cur.append(step)
            if step[1]:
                served_utts.append(cur)
                cur = []
        if len(served_utts) != len(utts) or cur:
            read.add("p1_token_count_off", 1)
        for wave, steps in zip(utts, served_utts):
            with torch.inference_mode():
                feats = frontend.offline_feats(wave, self.cfg1.frontend,
                                               *cmvn, device)
                if sum(c for c, _, _ in steps) != feats.shape[0]:
                    read.add("p1_rows_off", 1)
                    continue
                ref = online.pass1(sd1, self.cfg1, feats,
                                   [(c, f) for c, f, _ in steps])
            self._compare_p1(steps, ref, read)
        # pass 2, punctuation and the texts sent
        cache: List[str] = []
        want = []
        tok2id = {t: i for i, t in enumerate(self.ptokens)}
        for (_s, _e, wave), seg in zip(segs, call["segs"]):
            if seg["ids"] is None:
                read.add("token_count_off", 1)
                want.append(None)
                continue
            with torch.inference_mode():
                feats = frontend.offline_feats(wave, self.cfg2.frontend,
                                               *cmvn, device)
                ref = nets.paraformer(sd2, self.cfg2, feats,
                                      max_tokens=seg["cap"])
            self.p2._compare(seg, ref, read)
            asr_text = "".join(text.detok(seg["ids"], self.tokens))
            if not asr_text:
                want.append("")
                continue
            if seg["text"] != asr_text:
                read.worst("text_off", 1)
            want.append(self._punc(seg["windows"], asr_text, cache, tok2id,
                                   sd_punc, read))
        read.worst("text_off", want != call["texts"])

    def _chunk_len(self) -> int:
        f = self.cfg1.frontend
        return self.cfg1.chunk_size[1] * f.frame_shift * f.lfr_n

    def _compare_p1(self, steps, ref: online.Pass1, read: common.Readings):
        """Counts a step, then each served token's gap below the plain
        logits' best. A count that differs is excused only where CIF's
        running sum came within `cif_tie` of the threshold, one near tie a
        token; the tokens before the first such tie are then compared
        (the decoder is causal: nothing after a token reaches it)."""
        counts = [len(ids) for _, _, ids in steps]
        read.least("p1_cif_margin", ref.margin)
        ids = np.concatenate([ids for _, _, ids in steps]).astype(np.int64)
        keep = len(ids)
        if counts != ref.counts:
            ties = [j for dist, j in ref.near if dist < self.node["cif_tie"]]
            if len(ties) < max(1, abs(len(ids) - ref.logits.shape[0])):
                read.add("p1_token_count_off", 1)
                return
            read.add("p1_count_at_tie", 1)
            keep = min(ties)
        if keep:
            logits = ref.logits[:keep].float()
            got = logits.gather(-1, torch.as_tensor(
                ids[:keep], device=logits.device)[:, None])[:, 0]
            read.worst("p1_argmax_gap",
                       float((logits.max(-1).values - got).max()))

    def _punc(self, windows, asr_text, cache, tok2id, sd_punc, read):
        """The streaming punctuation of one pass-2 text followed from the
        served window decisions (as common.check_punc follows the offline
        loop), each served class read under the plain network's logits.
        Returns the text assembled from them."""
        mismatch = [0]
        seen = []

        def decide(bi, w_ids, cached):
            seen.append(bi)
            if (bi >= len(windows) or windows[bi][0] != list(w_ids)
                    or windows[bi][1] != cached):
                mismatch[0] += 1
                return [text.NOTPUNC] * len(w_ids)
            return windows[bi][2]

        out = online.punc_streaming(asr_text, cache, tok2id,
                                    self.pcfg.token_len,
                                    self.pcfg.cache_pop_trigger_limit, decide)
        read.worst("punc_window_off",
                   mismatch[0] + abs(len(seen) - len(windows)))
        with torch.inference_mode():
            for w_ids, cached, served_cls in windows[: len(seen)]:
                logits = nets.ct_transformer(sd_punc, self.pcfg, w_ids,
                                             cached).float()
                got = logits.gather(-1, torch.tensor(
                    served_cls, device=logits.device)[:, None])[:, 0]
                read.worst("argmax_gap",
                           float((logits.max(-1).values - got).max()))
        return out

    def control(self, waves: List[np.ndarray], seed: int, device,
                read: common.Readings):
        """The references in TF32 in the program's place, on each call fed
        in 60 ms windows: pass 1 in its plain chunking, pass 2 on the
        segments, punctuation on the texts; read as served ones."""
        online.float32_products()
        sd1, sd2, sd_vad, sd_punc = self.weights(seed, device)
        n = self.node
        cmvn = common.cmvn(n["cmvn"], self.cfg1.frontend.lfr_dim)
        vcmvn = common.cmvn(n["vad"]["cmvn"], self.vcfg.input_dim)
        tok2id = {t: i for i, t in enumerate(self.ptokens)}
        center = self.cfg1.chunk_size[1]
        for wave in waves:
            wins = [(min(960, len(wave) - a), a + 960 >= len(wave))
                    for a in range(0, len(wave), 960)]
            events = online.vad_events(
                sd_vad, self.vcfg, wave, wins, vcmvn,
                self.vcfg.max_end_silence_time,
                self.vcfg.max_single_segment_time, device)
            utts, segs = online.split(wave, wins, events, self._chunk_len())
            for u in utts:
                with torch.inference_mode():
                    feats = frontend.offline_feats(u, self.cfg1.frontend,
                                                   *cmvn, device)
                    sched = online.schedule(feats.shape[0], center)
                    ref = online.pass1(sd1, self.cfg1, feats, sched)
                    with common.tf32():
                        low = online.pass1(sd1, self.cfg1, feats, sched)
                ids = low.logits.argmax(-1).cpu().numpy()
                at = np.cumsum([0] + low.counts)
                steps = [(c, f, ids[at[i]: at[i + 1]])
                         for i, (c, f) in enumerate(sched)]
                self._compare_p1(steps, ref, read)
            cache: List[str] = []
            for _s, _e, seg in segs:
                with torch.inference_mode():
                    feats = frontend.offline_feats(seg, self.cfg2.frontend,
                                                   *cmvn, device)
                    ref = nets.paraformer(sd2, self.cfg2, feats)
                    with common.tf32():
                        low = nets.paraformer(sd2, self.cfg2, feats)
                got = {"ids": low.logits.argmax(-1).cpu().numpy()}
                self.p2._compare(got, ref, read)
                asr_text = "".join(text.detok(got["ids"], self.tokens))
                if not asr_text:
                    continue
                decided = []

                def decide(_bi, w_ids, cached):
                    with torch.inference_mode(), common.tf32():
                        cls = nets.ct_transformer(sd_punc, self.pcfg, w_ids,
                                                  cached).argmax(-1).tolist()
                    decided.append((list(w_ids), cached, cls))
                    return cls

                before = list(cache)
                online.punc_streaming(asr_text, cache, tok2id,
                                      self.pcfg.token_len,
                                      self.pcfg.cache_pop_trigger_limit,
                                      decide)
                self._punc(decided, asr_text, before, tok2id, sd_punc, read)
