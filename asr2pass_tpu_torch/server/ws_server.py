"""Asyncio websocket ASR server — reference-protocol compatible.

Speaks the exact JSON+binary protocol of the reference servers
(README.md:95-190, websocket-server-2pass.cpp):
  client -> first JSON {mode, chunk_size, chunk_interval, audio_fs,
            wav_name, wav_format, is_speaking, hotwords, itn, svs_itn,
            vad_tail_sil, vad_max_len, svs_lang}
  client -> binary s16le PCM frames
  client -> {"is_speaking": false} to end the utterance/file
  server -> {"text", "mode": online|offline|2pass-online|2pass-offline,
            "wav_name", "is_final"(, "timestamp", "stamp_sents")}

Counterpart of the JAX package's server/ws_server.py. The models run on the
device of the ServerModels (the card unless it was built with
device="cpu"); with a SenseVoice model loaded, pass 2 runs SenseVoice
with the connection's svs_lang and svs_itn. Threading model:
instead of the reference's decoder-thread pool with per-connection
strands (funasr-wss-server-2pass.cpp:511-538), decoding runs on one
executor thread per process (the card is the shared compute resource);
per-connection ordering falls out of one asyncio task per connection.
With use_engine, one StreamEngine batches every 2pass and online
connection, ticked by a background task, and offline uploads decode on
their own executor. `websockets` is imported in serve() only.

Every connection gets an id and a record (connection_records()): when
each audio message arrived with the stream's sample count after it, and,
on the engine path, when each partial and final was sent and how long it
waited: from the arrival of the message that completed the audio it
answers (a partial's chunk, a final's segment end point) to its send.
The waits also go to the stages ws.partial_wait and ws.final_wait.
"""
from __future__ import annotations

import asyncio
import bisect
import json
import logging
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from asr2pass_tpu_torch.frontend.audio import (ffmpeg_decode,
                                               linear_resample,
                                               load_pcm_bytes,
                                               load_wav_bytes)
from asr2pass_tpu_torch.runtime.engine import EngineAtCapacity, StreamEngine
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.server.engine import ServerModels

log = logging.getLogger("asr2pass.server")

# the newest connections whose records the server keeps
MAX_RECORDS = 4096


def _parse_hotwords(msg) -> dict:
    """Accept dict / json string / 'w1 w2' space form
    (websocket-server-2pass.cpp:424-473). Defensive like the reference:
    a malformed score (e.g. {"word": "high"}) falls back to the default
    weight 20 instead of killing the connection."""
    def score(v):
        try:
            return int(v)
        except (TypeError, ValueError):
            return 20

    if not msg:
        return {}
    if isinstance(msg, dict):
        return {str(k): score(v) for k, v in msg.items()}
    try:
        d = json.loads(msg)
        if isinstance(d, dict):
            return {str(k): score(v) for k, v in d.items()}
        if isinstance(d, list):
            return {str(w): 20 for w in d}
    except (json.JSONDecodeError, TypeError, ValueError):
        pass
    return {w: 20 for w in str(msg).split() if w}


class ConnectionState:
    def __init__(self, conn_id: int = 0):
        # the connection's record (AsrWsServer.connection_records): times
        # are time.perf_counter() seconds; samples[i] is the stream's
        # sample count after the audio message that arrived at arrived[i]
        self.record = {"id": conn_id, "wav_name": None, "mode": None,
                       "opened": time.perf_counter(), "closed": None,
                       "engine_slot": None, "engine_gen": None,
                       "arrived": [], "samples": [], "partials": [],
                       "finals": []}
        self.mode = "2pass"
        self.wav_name = "demo"
        self.wav_format = "pcm"
        self.audio_fs = 16000
        self.itn = True
        self.svs_lang = "auto"
        self.svs_itn = True
        self.session = None
        self.offline_buf = bytearray()
        self.hw_emb = None
        self.vad_tail_sil: Optional[int] = None
        self.vad_max_len: Optional[int] = None
        self.chunk_size = None
        self.started = False
        self.engine_sid: Optional[int] = None
        self.engine_final = False
        # set when an offline upload trips the size cap: subsequent binary
        # frames are dropped and the final message re-answers with the same
        # error until the next config JSON resets the connection state
        self.upload_rejected: Optional[str] = None
        # set after an engine-at-capacity refusal: the remaining frames of
        # that utterance are dropped (ONE error result was already sent —
        # re-attempting per frame would emit repeated is_final errors and
        # could start decoding mid-utterance if a slot frees); the next
        # config JSON re-arms the connection for a retry
        self.engine_refused = False


class AsrWsServer:
    def __init__(self, models: ServerModels, host: str = "0.0.0.0",
                 port: int = 10095, decode_workers: int = 1,
                 ssl_context=None, use_engine: bool = False,
                 engine_capacity: int = 128,
                 max_message_bytes: int = 16 << 20,
                 max_upload_bytes: int = 256 << 20,
                 upload_overlap: bool = False,
                 decide_async: bool = False):
        self.models = models
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        # upload size policy: cap a single websocket frame (websockets
        # enforces it at the transport) and the per-connection offline
        # upload buffer — the reference steps uploads through a bounded
        # ring instead of buffering unbounded bytes; here oversize uploads
        # get an error result and the buffer is dropped. 256 MB of s16
        # PCM ≈ 2.3 h of 16 kHz audio.
        self.max_message_bytes = max_message_bytes
        self.max_upload_bytes = max_upload_bytes
        self.executor = ThreadPoolExecutor(max_workers=decode_workers)
        # engine mode: whole-file offline decodes get their OWN executor,
        # so a 256 MB upload can never head-of-line block the engine tick
        # (and with it every live 2pass stream's partial cadence). The
        # reference isolates the same way with its decoder thread pool
        # (funasr-wss-server-2pass.cpp:531-538). Created in serve().
        self._offline_executor = None
        self._server = None
        # batched serving: one StreamEngine shared by all connections,
        # ticked by a background task (the batched replacement for the
        # reference's decoder-thread pool)
        self.use_engine = use_engine
        self.engine = None
        self.engine_capacity = engine_capacity
        self.upload_overlap = upload_overlap
        self.decide_async = decide_async
        self._engine_lock = None
        self._engine_conns = {}   # sid -> (ws, ConnectionState)
        self._opened = 0          # connections so far; the newest's id
        self._records: "OrderedDict[int, dict]" = OrderedDict()

    def connection_records(self) -> list:
        """The records of the newest MAX_RECORDS connections, oldest first
        (see the module's docstring; the lists of an open connection
        still grow)."""
        return list(self._records.values())

    def _note_sent(self, st: ConnectionState, r: dict):
        """Record an engine result's send and its wait (the time since the
        message holding its audio's last sample arrived)."""
        end = r.get("end_sample", -1)
        rec = st.record
        i = bisect.bisect_left(rec["samples"], end)
        if end <= 0 or i == len(rec["samples"]):
            return
        now = time.perf_counter()
        wait = now - rec["arrived"][i]
        if r["mode"] == "2pass-offline":
            rec["finals"].append([now, wait, end])
            METRICS.add_stage("ws.final_wait", wait)
        else:
            rec["partials"].append([now, wait])
            METRICS.add_stage("ws.partial_wait", wait)

    def stats(self) -> dict:
        """The "stats" action's report: the stage metrics and counters,
        the connections opened and still open; on the card, the attention
        kernels' launches and the memory allocated; with a fan-out, its
        numbers and the shards held."""
        report = METRICS.report()
        report["connections"] = {
            "opened": self._opened,
            "open": sum(r["closed"] is None
                        for r in self._records.values())}
        dev = self.models.device
        if dev.type == "cuda":
            import torch

            from asr2pass_tpu_torch.ops import attention as att

            report["launches"] = att.launch_counts_by_dtype()
            report["memory"] = {
                "allocated": torch.cuda.memory_allocated(dev),
                "max_allocated": torch.cuda.max_memory_allocated(dev)}
        fan = self.models.fanout
        if fan is not None:
            report["fanout"] = dict(
                fan.stats(), shards=sorted(self.models._tp_shard_cache))
        return report

    # -- decode helpers (run in executor) ------------------------------
    def _feed(self, st: ConnectionState, samples, is_final: bool):
        with METRICS.stage("2pass_feed"):
            res = st.session.feed(samples, is_final)
        METRICS.add_audio(res.snippet_time)
        return res

    def _offline_decode(self, st: ConnectionState):
        data = bytes(st.offline_buf)
        if st.wav_format in ("pcm", "PCM"):
            samples = load_pcm_bytes(data)
        else:
            try:
                samples, fs = load_wav_bytes(data)
                st.audio_fs = fs
            except Exception:
                # any-format upload (mp3/flac/...): ffmpeg, like the
                # reference's FfmpegLoad (audio.cpp:286-446); raw PCM as
                # the last resort
                try:
                    samples = ffmpeg_decode(
                        data, self.models.asr_cfg.frontend.fs)
                    st.audio_fs = self.models.asr_cfg.frontend.fs
                except Exception:
                    samples = load_pcm_bytes(data)
        if st.audio_fs != self.models.asr_cfg.frontend.fs:
            samples = linear_resample(samples, st.audio_fs,
                                      self.models.asr_cfg.frontend.fs)
        rec = self.models.offline_recognizer_cached(
            vad_tail_sil=st.vad_tail_sil or 800,
            vad_max_len=st.vad_max_len or 60000,
            use_svs=self.models.svs_params is not None,
            svs_lang=st.svs_lang, svs_itn=st.svs_itn,
            hotwords=getattr(st, "hotwords", None),
        )
        with METRICS.stage("offline_decode"):
            res = rec.transcribe(samples, hw_emb=st.hw_emb, use_itn=st.itn)
        METRICS.add_audio(res.snippet_time)
        return res

    # -- protocol ------------------------------------------------------
    async def _send(self, ws, payload: dict):
        await ws.send(json.dumps(payload, ensure_ascii=False))

    async def _handle_json(self, ws, st: ConnectionState, obj: dict):
        loop = asyncio.get_running_loop()
        if obj.get("action") == "stats":
            # observability extension (the reference has none, SURVEY §5)
            await self._send(ws, {"stats": self.stats()})
            return
        if not st.started:
            if st.engine_refused and set(obj) <= {"is_speaking"}:
                # the refused utterance's trailing end marker must not
                # re-attempt a slot claim (a second error final would
                # break the one-final-per-utterance ordering); only a
                # real config message re-arms the connection
                return
            st.upload_rejected = None
            st.engine_refused = False
            bad = []
            mode = obj.get("mode", st.mode)
            if mode in ("2pass", "online", "offline"):
                st.mode = mode
            elif "mode" in obj:
                bad.append("mode")
            st.wav_name = str(obj.get("wav_name", st.wav_name))
            st.record["wav_name"], st.record["mode"] = st.wav_name, st.mode
            st.wav_format = str(obj.get("wav_format", st.wav_format))
            if "audio_fs" in obj:
                try:
                    fs = int(obj["audio_fs"])
                    if fs > 0:
                        st.audio_fs = fs
                    else:
                        bad.append("audio_fs")
                except (TypeError, ValueError):
                    bad.append("audio_fs")
            st.itn = bool(obj.get("itn", st.itn))
            st.svs_lang = obj.get("svs_lang", st.svs_lang)
            st.svs_itn = bool(obj.get("svs_itn", st.svs_itn))
            for fld in ("vad_tail_sil", "vad_max_len"):
                v = obj.get(fld)
                if v is None:
                    setattr(st, fld, None)
                else:
                    try:
                        setattr(st, fld, int(v))
                    except (TypeError, ValueError):
                        setattr(st, fld, None)
                        bad.append(fld)
            cs = obj.get("chunk_size")
            if cs is not None:
                if isinstance(cs, str):
                    # FunASR-style CLI string form "5,10,5" (never
                    # char-iterate a string — "585" must not silently
                    # become [5, 8, 5])
                    cs = cs.split(",")
                parsed = None
                if isinstance(cs, (list, tuple)) and len(cs) == 3:
                    try:
                        vals = [int(x) for x in cs]
                    except (TypeError, ValueError):
                        vals = None
                    # bounded: the geometry sizes the connection's device
                    # caches — an unbounded client value would be a
                    # memory DoS knob
                    if (vals is not None and 1 <= vals[1] <= 128
                            and 0 <= vals[0] <= 64
                            and 0 <= vals[2] <= 64):
                        parsed = vals
                if parsed is None:
                    bad.append("chunk_size")
                else:
                    st.chunk_size = parsed
            try:
                hotwords = _parse_hotwords(obj.get("hotwords"))
            except Exception:
                bad.append("hotwords")
                hotwords = {}
            if bad:
                # malformed option values degrade to defaults and the
                # client is TOLD (one non-final protocol error result) —
                # the socket survives (the reference never drops a
                # connection over an option type)
                await self._send(ws, {
                    "text": "", "mode": st.mode, "wav_name": st.wav_name,
                    "is_final": False,
                    "error": "ignored malformed fields: " + ",".join(bad),
                })
            if self.models.server_hotwords:
                merged = dict(self.models.server_hotwords)
                merged.update(hotwords)
                hotwords = merged
            if hotwords:
                st.hw_emb = self.models.compile_hotwords(hotwords)
            st.hotwords = hotwords
            if st.mode in ("2pass", "online") and not self.use_engine:
                # session construction does device work (it sets up the
                # connection's streaming state on the card) — keep it OFF
                # the event loop so one connection's first message can
                # never freeze the others
                _hw, _cs = st.hw_emb, st.chunk_size
                st.session = await loop.run_in_executor(
                    self.executor,
                    lambda: self.models.create_session(
                        mode=st.mode, vad_tail_sil=st.vad_tail_sil,
                        vad_max_len=st.vad_max_len, hw_emb=_hw,
                        use_itn=st.itn, svs_lang=st.svs_lang,
                        svs_itn=st.svs_itn,
                        use_svs=self.models.svs_params is not None,
                        hotwords=hotwords, chunk_size=_cs,
                    ))
            elif (st.chunk_size is not None and self.use_engine
                  and st.mode != "offline"):
                # the batched engine shares ONE chunk geometry across
                # all slots — a per-connection override cannot apply
                ocfg = self.models.online_cfg or self.models.asr_cfg
                if tuple(st.chunk_size) != tuple(ocfg.chunk_size):
                    log.info("engine mode ignores per-connection "
                             "chunk_size %s (engine geometry %s)",
                             st.chunk_size, list(ocfg.chunk_size))
            st.started = True
        if obj.get("is_speaking") is False:
            if self.use_engine and st.mode != "offline":
                await self._engine_feed(ws, st, np.zeros(0, np.float32),
                                        True)
                st.started = False
                return
            if st.mode == "offline":
                if st.upload_rejected:
                    await self._send(ws, {
                        "text": "", "mode": "offline",
                        "wav_name": st.wav_name, "is_final": True,
                        "error": st.upload_rejected,
                    })
                    st.offline_buf.clear()
                    st.started = False
                    return
                res = await loop.run_in_executor(
                    self._offline_executor or self.executor,
                    self._offline_decode, st)
                payload = {
                    "text": res.text, "mode": "offline",
                    "wav_name": st.wav_name, "is_final": True,
                }
                if res.timestamps:
                    payload["timestamp"] = json.dumps(res.timestamps)
                    payload["stamp_sents"] = res.stamp_sents
                await self._send(ws, payload)
                st.offline_buf.clear()
            else:
                res = await loop.run_in_executor(
                    self.executor, self._feed, st,
                    np.zeros(0, np.float32), True)
                await self._emit_stream_results(ws, st, res, is_final=True)
                st.session.reset()
            st.started = False

    async def _emit_stream_results(self, ws, st: ConnectionState, res,
                                   is_final: bool = False):
        if st.mode == "online":
            if res.partial:
                await self._send(ws, {
                    "text": res.partial, "mode": "online",
                    "wav_name": st.wav_name, "is_final": False,
                })
        else:
            if res.partial:
                await self._send(ws, {
                    "text": res.partial, "mode": "2pass-online",
                    "wav_name": st.wav_name, "is_final": False,
                })
            if res.final_text:
                payload = {
                    "text": res.final_text, "mode": "2pass-offline",
                    "wav_name": st.wav_name, "is_final": False,
                }
                if res.timestamps:
                    payload["timestamp"] = json.dumps(res.timestamps)
                    payload["stamp_sents"] = res.stamp_sents
                await self._send(ws, payload)
        if is_final:
            await self._send(ws, {
                "text": "", "mode": st.mode, "wav_name": st.wav_name,
                "is_final": True,
            })

    async def _handle_binary(self, ws, st: ConnectionState, data: bytes,
                             arrived: float = 0.0):
        if st.mode == "offline":
            if st.upload_rejected:
                return
            if len(data) > self.max_message_bytes:
                # single websocket frame over the per-frame cap: answer
                # gracefully instead of the transport's 1009 close (the
                # transport backstop sits above max_upload_bytes, so a
                # whole-file single-frame upload reaches this path)
                st.upload_rejected = ("message exceeds max_message_bytes=%d;"
                                      " chunk the upload"
                                      % self.max_message_bytes)
            elif len(st.offline_buf) + len(data) > self.max_upload_bytes:
                st.upload_rejected = ("upload exceeds max_upload_bytes=%d"
                                      % self.max_upload_bytes)
            if st.upload_rejected:
                st.offline_buf.clear()
                await self._send(ws, {
                    "text": "", "mode": "offline",
                    "wav_name": st.wav_name, "is_final": True,
                    "error": st.upload_rejected,
                })
                return
            st.offline_buf.extend(data)
            return
        samples = load_pcm_bytes(data)
        if st.audio_fs != self.models.asr_cfg.frontend.fs:
            samples = linear_resample(samples, st.audio_fs,
                                      self.models.asr_cfg.frontend.fs)
        if self.use_engine:
            rec = st.record
            rec["samples"].append((rec["samples"][-1] if rec["samples"]
                                   else 0) + len(samples))
            rec["arrived"].append(arrived)
            await self._engine_feed(ws, st, samples, False)
            return
        if st.session is None:
            return
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(self.executor, self._feed, st,
                                         samples, False)
        await self._emit_stream_results(ws, st, res)

    # -- engine-backed path --------------------------------------------
    async def _engine_feed(self, ws, st: ConnectionState, samples,
                           is_final: bool):
        if st.engine_refused:
            return
        if getattr(st, "engine_sid", None) is None:
            try:
                async with self._engine_lock:
                    st.engine_sid = self.engine.open(
                        hw_emb=st.hw_emb,
                        hotwords=getattr(st, "hotwords", None),
                        use_itn=st.itn, svs_lang=st.svs_lang,
                        svs_itn=st.svs_itn, vad_tail_sil=st.vad_tail_sil,
                        vad_max_len=st.vad_max_len, mode=st.mode,
                    )
            except EngineAtCapacity as e:
                # protocol error result instead of a dead socket: the
                # connection stays open so the client can retry (with a
                # fresh config message) after other streams drain; the
                # current utterance's remaining frames are dropped
                st.started = False
                st.engine_refused = True
                await self._send(ws, {
                    "text": "", "mode": st.mode, "wav_name": st.wav_name,
                    "is_final": True, "error": str(e),
                })
                return
            self._engine_conns[st.engine_sid] = (ws, st)
            st.record["engine_slot"] = st.engine_sid
            st.record["engine_gen"] = self.engine.slots[st.engine_sid].gen
        self.engine.feed(st.engine_sid, samples, is_final)
        if is_final:
            st.engine_final = True
        self._engine_wakeup.set()

    def _step(self):
        with METRICS.stage("tick"):
            self.engine.step()

    async def _engine_loop(self):
        """Engine loop. Event-driven, not busy-polling: when no slot has
        work and nothing is in flight, the loop parks on a wakeup event
        that feed() sets — no 5-20 ms wakeups scanning idle slots (scales
        to the capacities the pipelined tick unlocks). A short timed wait
        remains only while the async pass-2 lane may still post results.

        Containment: one poisoned tick (a bad frame, a transient device
        error) must not kill the loop task and hang every connection —
        step() failures are logged and the loop continues (the reference
        survives the analogous case via per-task try + supervisord)."""
        loop = asyncio.get_running_loop()
        while True:
            try:
                await self._engine_loop_body(loop)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("engine loop failure; serving continues")
                await asyncio.sleep(0.1)

    async def _engine_loop_body(self, loop):
        while True:
            has_work = self.engine is not None and (
                self.engine.has_inflight() or any(
                    self.engine.slot_has_work(slot)
                    for slot in self.engine.slots))
            if has_work:
                async with self._engine_lock:
                    try:
                        await loop.run_in_executor(self.executor,
                                                   self._step)
                    except Exception:
                        log.exception(
                            "engine tick failure; serving continues")
                        await asyncio.sleep(0.05)
            # results may also arrive from the async pass-2 lane while no
            # tick work is pending — poll every iteration. drained() is
            # read BEFORE the poll: a lane that posts its result between
            # the two would otherwise have it sent after the is_final,
            # which ends the client's read
            for sid, (ws, st) in list(self._engine_conns.items()):
                done = (getattr(st, "engine_final", False)
                        and self.engine.drained(sid))
                results = self.engine.poll(sid)
                for r in results:
                    payload = {"text": r["text"], "mode": r["mode"],
                               "wav_name": st.wav_name,
                               "is_final": False}
                    if "timestamp" in r:
                        payload["timestamp"] = json.dumps(r["timestamp"])
                        payload["stamp_sents"] = r.get("stamp_sents", [])
                    self._note_sent(st, r)
                    try:
                        await self._send(ws, payload)
                    except Exception:
                        pass
                if done:
                    st.engine_final = False
                    try:
                        await self._send(ws, {
                            "text": "", "mode": st.mode,
                            "wav_name": st.wav_name,
                            "is_final": True})
                    except Exception:
                        pass
            if has_work:
                await asyncio.sleep(0.005)  # yield between ticks
            else:
                # pass-2 lane may still be decoding for some slot: keep a
                # timed poll; otherwise park until the next feed()
                p2_busy = any(s.active and s.p2_inflight
                              for s in self.engine.slots)
                self._engine_wakeup.clear()
                try:
                    await asyncio.wait_for(
                        self._engine_wakeup.wait(),
                        timeout=0.02 if p2_busy else None)
                except asyncio.TimeoutError:
                    pass

    async def handler(self, ws):
        self._opened += 1
        st = ConnectionState(self._opened)
        self._records[self._opened] = st.record
        while len(self._records) > MAX_RECORDS:
            self._records.popitem(last=False)
        try:
            async for message in ws:
                if isinstance(message, (bytes, bytearray)):
                    await self._handle_binary(ws, st, bytes(message),
                                              time.perf_counter())
                else:
                    try:
                        obj = json.loads(message)
                    except json.JSONDecodeError:
                        log.warning("bad json: %r", message[:100])
                        continue
                    await self._handle_json(ws, st, obj)
        except Exception as e:  # connection teardown
            log.info("connection closed: %s", e)
        finally:
            st.record["closed"] = time.perf_counter()
            sid = getattr(st, "engine_sid", None)
            if sid is not None:
                self._engine_conns.pop(sid, None)
                self.engine.close(sid)

    async def serve(self):
        import websockets

        if self.use_engine:
            # the tick owns self.executor; offline uploads decode on
            # their own pool so they cannot stall live 2pass streams
            self._offline_executor = ThreadPoolExecutor(
                max_workers=max(1, self.executor._max_workers),
                thread_name_prefix="offline-decode")
            self.engine = StreamEngine(self.models,
                                       capacity=self.engine_capacity,
                                       pass2_async=True, fused_fetch=True,
                                       upload_overlap=self.upload_overlap,
                                       decide_async=self.decide_async)
            await asyncio.get_running_loop().run_in_executor(
                self.executor, self.engine.warmup)
            await asyncio.get_running_loop().run_in_executor(
                self.executor, self.engine.warm_pass2_ring)
            self._engine_lock = asyncio.Lock()
            self._engine_wakeup = asyncio.Event()
            self._engine_task = asyncio.get_running_loop().create_task(
                self._engine_loop())
        # transport frame cap is a backstop sized above the upload cap so a
        # whole-file single-frame upload gets the graceful per-frame error
        # in _handle_binary instead of a 1009 close
        self._server = await websockets.serve(
            self.handler, self.host, self.port, ssl=self.ssl_context,
            max_size=max(self.max_message_bytes,
                         self.max_upload_bytes) + (1 << 20),
        )
        log.info("listening on %s:%d%s", self.host, self.port,
                 " (engine-batched)" if self.use_engine else "")
        return self._server

    def run_forever(self):
        async def main():
            await self.serve()
            await asyncio.Future()

        try:
            asyncio.run(main())
        finally:
            if self.engine is not None:
                self.engine.shutdown()
            if self._offline_executor is not None:
                self._offline_executor.shutdown(wait=False)
            # the worker ranks leave serve_worker
            if self.models.fanout is not None:
                self.models.fanout.stop()
