"""Paced 2pass streams through the websocket server: N callers, each on its
own connection, stream calls in real time, as the repository's clients
do (clients/asr_client_api.py): a first message with mode 2pass,
chunk_size [5, 10, 5] and chunk_interval 10, then 60 ms binary messages
of 16-bit PCM, then {"is_speaking": false}; the caller reads results
until the final one, closes, and opens a new connection for its next
call.

The server runs in the run's process; the callers run in one child
process (this file run as a script, importing numpy and websockets
only), so that their sending does not share the server's interpreter.
A call is speech-like bursts between pauses of digital silence, made as
bulk_files makes a file. The cell's parameters:
- callers: N, the connections streaming at once;
- file_seconds: the lengths of the pool's calls, cycled through;
- pool_calls: the calls in the pool;
- burst_s, pause_s: the ranges bursts (utterances) and pauses are drawn
  from; layout_seed draws each call's bursts and pauses;
- sample_files: how many callers' calls the check compares;
- message_ms, chunk_size, chunk_interval: what the clients send;
- ramp_s: caller i starts i * ramp_s / N seconds after the first;
- lead_s: seconds all N stream before the window opens.
The run's seed draws the sound inside each burst, the order each caller
takes the pool's calls in, and the sampled callers.

Set-up ends when every caller has streamed for lead_s. The window then
opens; after `seconds` each caller finishes its current utterance (the
burst it is in and the pause after it), sends the end of its call and
waits for its final result; the window closes at the last final. Every
wait has a time limit. The window's audio seconds are those of the
utterances whose 2pass-offline final was sent inside it, each utterance
being the stream's audio from the previous final's segment end (or the
call's start) to its own.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

FS = 16000
CONNECT_S = 30.0        # a connection's opening
FINAL_S = 60.0          # the final result after a call's end
CHILD_START_S = 3.0     # the child's start-up before the first caller


def pool(params: dict, seed: int, device="cpu") -> List[np.ndarray]:
    """The pool's calls, float32 on the PCM grid (the sound made on
    `device`)."""
    import torch

    from benchmark.traffic import bulk_files

    lay = np.random.default_rng(params["layout_seed"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lengths = params["file_seconds"]
    calls = []
    for k in range(params["pool_calls"]):
        seconds = lengths[k % len(lengths)]
        wave = torch.zeros(int(seconds * FS), dtype=torch.float64,
                           device=device)
        for start, length in bulk_files.layout(
                seconds, params["burst_s"], params["pause_s"], lay):
            a = int(start * FS)
            burst = bulk_files.synth(length, g, device)
            wave[a: a + len(burst)] = burst
        pcm = torch.round(wave * 32768.0).clamp(-32768, 32767) / 32768.0
        calls.append(pcm.float().cpu().numpy())
    return calls


def passes(n: int, seed: int):
    """Pool indices of each pass: a new permutation of the pool."""
    from benchmark.traffic import bulk_files

    return bulk_files.passes(n, seed)


def cut_points(wave: np.ndarray) -> List[int]:
    """Where a call may end after its window: the start of each burst but
    the first (the end of the pause after the one before) and the call's
    end."""
    loud = np.flatnonzero(wave != 0)
    if not len(loud):
        return [len(wave)]
    starts = loud[np.r_[False, np.diff(loud) > FS // 10]]
    return [int(s) for s in starts] + [len(wave)]


class Window:
    """What the window served, from the server's connection records, the
    engine's records and the callers' own."""

    def __init__(self):
        self.attempted = 0          # calls that overlapped the window
        self.failed = 0
        self.errors: List[str] = []
        self.done: List[tuple] = []  # (call name, end sample) of each final
        self.window_s = 0.0
        self.audio_s = 0.0
        self.t_open = self.t_close = 0.0
        self.partial_waits: List[float] = []
        self.final_waits: List[float] = []
        self.stages: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}
        self.calls: Dict[str, dict] = {}    # every call, by name
        self.records: Dict[str, dict] = {}  # server records, by call name
        self.tokens_p1 = self.frames_p1 = 0
        self.report: Dict[str, list] = {}   # the program's stage report

    @property
    def completed(self) -> int:
        return len(self.done)


class Load:
    """The cell's traffic bound to the family's service (the server the
    launcher builds, with the family's recorder on its engine)."""

    def __init__(self, family, entry, params: dict, seed: int, device):
        self.family = family
        self.service = entry
        self.params = params
        self.seed = seed
        self.device = device
        self.files = pool(params, seed, device)
        n = params["callers"]
        self.n = n
        per = -(-16 * n // len(self.files))       # 16 calls a caller
        order = passes(len(self.files), seed)
        seq = [i for _ in range(per) for i in next(order)]
        self.plan = [[seq[(j * n + i) % len(seq)] for j in range(16)]
                     for i in range(n)]
        rng = np.random.default_rng(seed + 7)
        k = min(params["sample_files"], n)
        self.sampled = sorted(int(x) for x in rng.choice(n, k,
                                                        replace=False))
        self.tmp = tempfile.TemporaryDirectory(prefix="paced_2pass_")
        self.child = None
        self.out_path = os.path.join(self.tmp.name, "callers.json")

    # -- the child -----------------------------------------------------
    def _spec(self) -> dict:
        audio = os.path.join(self.tmp.name, "calls.npy")
        flat = np.concatenate(self.files)
        np.save(audio, np.round(flat * 32768.0).astype(np.int16))
        offs = np.cumsum([0] + [len(f) for f in self.files]).tolist()
        p = self.params
        t0 = time.time() + CHILD_START_S
        return {
            "port": self.service.port, "audio": audio, "offsets": offs,
            "cuts": [cut_points(f) for f in self.files],
            "plan": self.plan, "sampled": self.sampled,
            "message": FS * p["message_ms"] // 1000,
            "first": {"mode": "2pass", "chunk_size": p["chunk_size"],
                      "chunk_interval": p["chunk_interval"],
                      "audio_fs": FS, "wav_format": "pcm",
                      "is_speaking": True, "itn": False, "hotwords": ""},
            "starts": [t0 + i * p["ramp_s"] / self.n for i in range(self.n)],
            "out": self.out_path,
        }

    def warm(self) -> None:
        """Start the callers and return once every one of them has
        streamed for lead_s (the ramp is set-up)."""
        spec = self._spec()
        path = os.path.join(self.tmp.name, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        self.child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        until = spec["starts"][-1] + self.params["lead_s"]
        while time.time() < until:
            if self.child.poll() is not None:
                raise RuntimeError(
                    f"the callers exited during the ramp: {self._log()}")
            time.sleep(0.1)

    def _log(self) -> str:
        try:
            return self.child.communicate(timeout=5)[0][-2000:]
        except subprocess.TimeoutExpired:
            return ""

    def drive(self, seconds: float, traced=None) -> Window:
        out = Window()
        svc = self.service
        rec = svc.recorder
        if traced is not None:
            traced.start()
        out.t_open = time.perf_counter()
        rec.open_window(out.t_open)
        self.child.stdin.write(f"stop {time.time() + seconds}\n")
        self.child.stdin.flush()
        rest = (max(self.params["burst_s"]) + max(self.params["pause_s"])
                + 2 * FINAL_S + CONNECT_S)
        try:
            self.child.wait(timeout=seconds + rest)
        except subprocess.TimeoutExpired:
            self.child.kill()
            out.errors.append("the callers did not finish in time")
        if traced is not None:
            traced.stop()
        close = time.perf_counter()
        rec.close_window()
        try:
            with open(self.out_path) as f:
                calls = json.load(f)
        except (OSError, ValueError):
            calls = []
            out.errors.append("the callers left no record")
        self._window(out, calls, close)
        return out

    def _window(self, out: Window, calls: list, close: float) -> None:
        """The window's numbers from the records."""
        shift = time.time() - time.perf_counter()
        records = {r["wav_name"]: r
                   for r in self.service.server.connection_records()
                   if r["wav_name"]}
        finals = [f[0] for r in records.values() for f in r["finals"]
                  if f[0] >= out.t_open]
        out.t_close = max(finals) if finals else close
        out.window_s = out.t_close - out.t_open
        lo, hi = out.t_open, out.t_close
        for c in calls:
            c["opened"] -= shift
            c["closed"] = (c["closed"] - shift if c["closed"]
                           else float("inf"))
            out.calls[c["name"]] = c
            r = records.get(c["name"])
            if r is not None:
                out.records[c["name"]] = r
            if c["closed"] < lo or c["opened"] > hi:
                continue
            out.attempted += 1
            if c["errors"]:
                out.failed += 1
                out.errors += [f"{c['name']}: {e}" for e in c["errors"]]
        for name, r in records.items():
            prev = 0
            for sent, wait, end in r["finals"]:
                if lo <= sent <= hi:
                    out.done.append((name, end))
                    out.audio_s += (end - prev) / FS
                    out.final_waits.append(wait)
                prev = end
            out.partial_waits += [w for sent, w in r["partials"]
                                  if lo <= sent <= hi]
        rec = self.service.recorder
        out.stages = rec.stages
        out.counts = rec.counts
        out.report = rec.report
        out.tokens_p1, out.frames_p1 = rec.p1_rate()

    def summary(self, w: Window) -> str:
        def pct(xs, p):
            from benchmark.lib import serving

            v = serving.percentile(xs, p)
            return "none" if v is None else f"{1000 * v:.1f}"
        return (f"{self.n} callers, {w.attempted} calls, {w.completed} "
                f"finals, {w.audio_s:.1f} audio s; partial p50/p90/p95 "
                f"{pct(w.partial_waits, 50)}/{pct(w.partial_waits, 90)}/"
                f"{pct(w.partial_waits, 95)} ms over "
                f"{len(w.partial_waits)}, final p50/p90 "
                f"{pct(w.final_waits, 50)}/{pct(w.final_waits, 90)} ms over "
                f"{len(w.final_waits)}; pass 1 fired "
                f"{w.tokens_p1 / max(w.frames_p1, 1):.3f} tokens an LFR "
                f"frame; counts {json.dumps(w.counts)}; stages (p50, p95 "
                f"ms, count of the newest) {json.dumps(w.report)}")

    def sample(self, window: Window, seed: int) -> list:
        """The sampled callers' calls that overlapped the window, each
        whole, with what the service did for them."""
        return self.service.recorder.calls(self, window)

    def flops(self, window: Window) -> float:
        return self.service.recorder.flops(window)


# -- the child: the callers -------------------------------------------------

async def _call(spec, audio, caller: int, j: int, state: dict) -> dict:
    import websockets

    k = spec["plan"][caller][j % len(spec["plan"][caller])]
    a, b = spec["offsets"][k], spec["offsets"][k + 1]
    wave = audio[a:b]
    cuts = spec["cuts"][k]
    name = f"c{caller}.{j}"
    keep = caller in spec["sampled"]
    call = {"name": name, "caller": caller, "index": j, "pool": k,
            "opened": time.time(), "closed": None, "sent": 0,
            "messages": [], "partials": 0, "ended": False, "errors": []}
    msg = spec["message"]
    try:
        ws = await asyncio.wait_for(websockets.connect(
            f"ws://127.0.0.1:{spec['port']}", max_size=1 << 24,
            open_timeout=CONNECT_S), CONNECT_S)
    except Exception as exc:  # a failed call: counted, then on
        call["errors"].append(f"connect: {type(exc).__name__}: {exc}")
        call["closed"] = time.time()
        return call
    try:
        first = dict(spec["first"], wav_name=name)
        await ws.send(json.dumps(first))
        done = asyncio.get_running_loop().create_future()

        async def reader():
            try:
                async for m in ws:
                    r = json.loads(m)
                    if r.get("error"):
                        call["errors"].append(r["error"])
                    if r.get("mode") == "2pass-online":
                        call["partials"] += 1
                    if keep:
                        call["messages"].append(
                            [r.get("mode"), r.get("text", ""),
                             bool(r.get("is_final"))])
                    if r.get("is_final"):
                        call["ended"] = True
                        break
            except Exception as exc:
                call["errors"].append(f"read: {type(exc).__name__}: {exc}")
            if not done.done():
                done.set_result(True)

        task = asyncio.create_task(reader())
        t0 = time.time()
        end = len(wave)
        pos = 0
        while pos < end:
            stop = state["stop"]
            if stop is not None and time.time() >= stop and end == len(wave):
                end = next(c for c in cuts if c >= pos)
                if pos >= end:
                    break
            n = min(msg, end - pos)
            await asyncio.sleep(max(0.0, t0 + pos / FS - time.time()))
            await ws.send(wave[pos: pos + n].tobytes())
            pos += n
            if done.done():
                break
        call["sent"] = pos
        await ws.send(json.dumps({"is_speaking": False}))
        try:
            await asyncio.wait_for(asyncio.shield(done), FINAL_S)
        except asyncio.TimeoutError:
            call["errors"].append("no final result in time")
        if not call["ended"] and not call["errors"]:
            call["errors"].append("the connection ended before its final")
        task.cancel()
    except Exception as exc:
        call["errors"].append(f"{type(exc).__name__}: {exc}")
    finally:
        call["closed"] = time.time()
        try:
            await asyncio.wait_for(ws.close(), CONNECT_S)
        except Exception:
            pass
    return call


async def _caller(spec, audio, caller: int, state: dict, out: list):
    await asyncio.sleep(max(0.0, spec["starts"][caller] - time.time()))
    j = 0
    while state["stop"] is None or time.time() < state["stop"]:
        out.append(await _call(spec, audio, caller, j, state))
        j += 1


def child_main(path: str) -> int:
    with open(path) as f:
        spec = json.load(f)
    audio = np.load(spec["audio"], mmap_mode="r")
    state = {"stop": None}

    def listen():
        for line in sys.stdin:
            if line.startswith("stop "):
                state["stop"] = float(line.split()[1])
                return
        state["stop"] = time.time()      # the parent went away

    threading.Thread(target=listen, daemon=True).start()
    calls: list = []

    async def main():
        await asyncio.gather(*[_caller(spec, audio, i, state, calls)
                               for i in range(len(spec["starts"]))])

    asyncio.run(main())
    with open(spec["out"], "w") as f:
        json.dump(calls, f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1]))
