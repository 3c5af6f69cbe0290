"""The port's websocket server (asr2pass_tpu_torch.server) on the CPU: the
reference client's message sequence replayed against it over a real
socket in 2pass, online, offline and engine modes, and against the JAX
server with the same weights (equal finals, timestamps and concatenated
partials; message boundaries depend on timing and are not compared); the
protocol cases of tests/test_server.py that need no SenseVoice, LM or CER
harness; and the launcher's build_models on saved model dirs."""
import asyncio
import io
import json
import time
import wave

import jax
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import ct_transformer as jct
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime import engine as jengine
from asr2pass_tpu.server.engine import ServerModels as JServerModels
from asr2pass_tpu.server.ws_server import AsrWsServer as JAsrWsServer
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.runtime import model_zoo
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.server.engine import ServerModels
from asr2pass_tpu_torch.server.run_server import build_models, parser
from asr2pass_tpu_torch.server.ws_server import AsrWsServer, _parse_hotwords
from asr2pass_tpu_torch.text.itn import ChineseITN
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer as TTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import jax_params, tiny_cfgs

PUNC_TOKENS = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores: two threads
    a process keep the other files' timing-sensitive tests unstarved."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_final_after_results(monkeypatch):
    """The JAX server's engine loop polls a connection's results before it
    reads drained() (its ws_server.py:479-492): a pass-2 result that the
    lane posts between the two goes out after the is_final, which ends
    the client's read, so under load a replay misses a final. Here the
    JAX engine's drained() also waits for the posted results to be
    polled; the port's loop reads drained() before it polls
    (test_engine_final_follows_its_results)."""
    drained = jengine.StreamEngine.drained
    monkeypatch.setattr(
        jengine.StreamEngine, "drained",
        lambda self, sid: drained(self, sid) and not self.slots[sid].results)


@pytest.fixture(scope="module")
def trees():
    """JAX weights: paraformer_tiny with the bicif timestamp head (as
    tests/test_protocol_replay.py), VadConfig(), punc_tiny(300)."""
    jcfg, tcfg = tiny_cfgs(timestamp=True)
    return dict(
        jcfg=jcfg, tcfg=tcfg, asr=jax_params(jcfg, 0),
        vad=jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                               jconfig.VadConfig())),
        punc=jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(2),
                                               jconfig.punc_tiny(300))))


@pytest.fixture(scope="module")
def models(trees):
    return ServerModels(
        asr_params=params_from_jax(trees["asr"]), asr_cfg=trees["tcfg"],
        vocab=TVocab(make_test_vocab(trees["tcfg"].vocab_size).tokens),
        vad_params=params_from_jax(trees["vad"]),
        vad_cfg=tconfig.VadConfig(),
        punc_params=params_from_jax(trees["punc"]),
        punc_cfg=tconfig.punc_tiny(300),
        punc_tokenizer=TTokenizer(PUNC_TOKENS), device="cpu")


@pytest.fixture(scope="module")
def jax_models(trees):
    return JServerModels(
        asr_params=trees["asr"], asr_cfg=trees["jcfg"],
        vocab=make_test_vocab(trees["jcfg"].vocab_size),
        vad_params=trees["vad"], vad_cfg=jconfig.VadConfig(),
        punc_params=trees["punc"], punc_cfg=jconfig.punc_tiny(300),
        punc_tokenizer=JTokenizer(PUNC_TOKENS))


def _pcm(seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(16000 * seconds)) * 0.1).clip(-1, 1)
    return (x * 32767).astype("<i2").tobytes()


async def _serving(server_cls, models, coro_fn, **kw):
    server = server_cls(models, host="127.0.0.1", port=0, **kw)
    srv = await server.serve()
    port = srv.sockets[0].getsockname()[1]
    try:
        return await coro_fn(server, port)
    finally:
        if getattr(server, "_engine_task", None) is not None:
            server._engine_task.cancel()
        srv.close()
        await srv.wait_closed()
        if server.engine is not None:
            server.engine.shutdown()
        server.executor.shutdown(wait=False)


def _serve(models, coro_fn, server_cls=AsrWsServer, **kw):
    return asyncio.run(_serving(server_cls, models, coro_fn, **kw))


# -- the reference client's replay -------------------------------------------

def _reference_first_message(mode, wav_name, **fields):
    """funasr_wss_client.py:241-244 field set with its argparse defaults
    (tests/test_protocol_replay.py:63-82); `fields` replace some."""
    return json.dumps({
        "mode": mode, "chunk_size": [5, 10, 5], "chunk_interval": 10,
        "audio_fs": 16000, "wav_name": wav_name, "wav_format": "pcm",
        "is_speaking": True, "hotwords": json.dumps({"阿里巴巴": 20}),
        "itn": True, "svs_itn": True, "vad_tail_sil": 350,
        "vad_max_len": 20000, "svs_lang": "auto", **fields,
    })


async def _reference_replay(port, mode, wav_name, audio_bytes, **fields):
    """The reference client's send loop (9600-sample frames for chunk_size
    [5, 10, 5] and chunk_interval 10, then {"is_speaking": false}) and its
    receive loop's termination (tests/test_protocol_replay.py:85-121)."""
    import websockets

    stride = int(60 * 10 / 10 / 1000 * 16000 * 2)
    msgs = []
    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(_reference_first_message(mode, wav_name, **fields))
        chunk_num = (len(audio_bytes) - 1) // stride + 1
        for i in range(chunk_num):
            await ws.send(audio_bytes[i * stride: (i + 1) * stride])
            if i == chunk_num - 1:
                await ws.send(json.dumps({"is_speaking": False}))
            await asyncio.sleep(0.001)
        while True:
            meg = json.loads(await asyncio.wait_for(ws.recv(), timeout=120))
            msgs.append(meg)
            assert isinstance(meg["text"], str)
            if mode == "offline" and meg.get("mode") == "offline":
                break
            if meg.get("is_final"):
                break
    return msgs


def _assert_timestamp_schema(meg):
    """timestamp a JSON string of [s_ms, e_ms] int pairs, stamp_sents the
    record list of websocket-server-2pass.cpp:84-96."""
    if "timestamp" not in meg:
        return
    parsed = json.loads(meg["timestamp"])
    for pair in parsed:
        assert (isinstance(pair, list) and len(pair) == 2
                and all(isinstance(v, int) for v in pair))
        assert 0 <= pair[0] <= pair[1]
    for rec in meg["stamp_sents"]:
        assert set(rec) == {"text_seg", "punc", "start", "end", "ts_list"}


def _summary(msgs):
    """What the finals and partials carry, timing-free: the concatenated
    partial text, and each final result's (mode, text, timestamp)."""
    partial = "".join(m["text"] for m in msgs
                      if m["mode"] in ("2pass-online", "online"))
    finals = [(m["mode"], m["text"], m.get("timestamp"))
              for m in msgs if m["mode"] in ("2pass-offline", "offline")]
    return partial, finals


def _wav_8k(seconds, seed):
    """A WAV file at 8 kHz: the upload the server resamples to 16 kHz."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(_pcm(seconds / 2, seed))
    return buf.getvalue()


_REPLAYS = {
    "2pass": ("2pass", {}, 2.4, 1),
    "online": ("online", {}, 1.8, 3),
    "offline": ("offline", {}, 2.0, 2),
    "engine": ("2pass", dict(use_engine=True, engine_capacity=4), 2.4, 4),
    # an 8 kHz WAV upload: both servers resample on their default, the
    # native resampler
    "offline_8k": ("offline", {}, 2.0, 5,
                   dict(audio_fs=8000, wav_format="wav")),
}


@pytest.mark.parametrize("case", list(_REPLAYS))
def test_replay_matches_jax_server(models, jax_models, case):
    mode, kw, seconds, seed, *fields = _REPLAYS[case]
    fields = fields[0] if fields else {}
    audio = (_wav_8k(seconds, seed) if fields.get("audio_fs") == 8000
             else _pcm(seconds, seed))
    msgs = {}
    tnb.reset_call_counts()
    for name, cls, m in (("port", AsrWsServer, models),
                         ("jax", JAsrWsServer, jax_models)):
        msgs[name] = _serve(
            m, lambda server, port: _reference_replay(port, mode, "w",
                                                      audio, **fields),
            server_cls=cls, **kw)
    # the upload went through the port's native resampler, once
    assert tnb.call_counts()["resample"] == (1 if fields else 0)
    got = msgs["port"]
    for m in got:
        assert m["wav_name"] == "w"
        assert isinstance(m["is_final"], bool)
        _assert_timestamp_schema(m)
    if mode == "offline":
        assert len(got) == 1 and got[0]["mode"] == "offline"
        assert got[0]["is_final"] is True and "timestamp" in got[0]
    else:
        finals = [i for i, m in enumerate(got) if m["is_final"]]
        assert finals == [len(got) - 1]
        allowed = ({"online"} if mode == "online"
                   else {"2pass-online", "2pass-offline"}) | {mode}
        assert {m["mode"] for m in got} <= allowed
    partial, finals = _summary(got)
    assert _summary(msgs["jax"]) == (partial, finals)
    if mode != "offline":
        assert partial
    if mode != "online":
        assert finals and all(ts for _, _, ts in finals)


def test_engine_final_follows_its_results(models, jax_models, monkeypatch):
    """A pass-2 result that the lane posts just after the engine loop
    polled a connection (here a poll that finds only lane work left waits
    for it) still goes out before that connection's is_final: the loop
    reads drained() before it polls. The replay equals the JAX
    server's."""
    from asr2pass_tpu_torch.runtime.engine import StreamEngine

    poll = StreamEngine.poll

    def late_poll(self, sid):
        out = poll(self, sid)
        slot = self.slots[sid]
        with self._results_lock:        # the lane settles under it
            inflight = slot.p2_inflight
            slot.p2_inflight = 0
            lane_only = inflight and self.drained(sid)
            slot.p2_inflight = inflight
        deadline = time.time() + 60
        while lane_only and slot.p2_inflight and time.time() < deadline:
            time.sleep(0.005)
        return out

    monkeypatch.setattr(StreamEngine, "poll", late_poll)
    audio = _pcm(2.4, 4)
    msgs = {name: _serve(m, lambda server, port: _reference_replay(
        port, "2pass", "w", audio), server_cls=cls, use_engine=True,
        engine_capacity=4)
        for name, cls, m in (("port", AsrWsServer, models),
                             ("jax", JAsrWsServer, jax_models))}
    got = msgs["port"]
    assert [m["is_final"] for m in got] == [False] * (len(got) - 1) + [True]
    assert _summary(got) == _summary(msgs["jax"])
    assert _summary(got)[1]


# -- the deployed hotword model and SenseVoice pass 2 ----------------------

@pytest.fixture(scope="module")
def dir_models(trees, tmp_path_factory):
    """(port, JAX) ServerModels pairs built from saved dirs: "hotword"
    is a converted hotword model dir (paraformer_tiny with the hotword
    block, a hotword_compiler subtree without a null row, a seg_dict)
    through build_models; "svs" adds --svs-dir (sensevoice_tiny with a
    2-block tp stack) to the trees' model. Both with the trees' VAD and
    punctuation dirs and ITN."""
    from asr2pass_tpu.models import hotword as jhw
    from asr2pass_tpu.runtime import model_zoo as jzoo
    from asr2pass_tpu.text.itn import ChineseITN as JITN
    from torch_parity import svs_tree

    tmp = tmp_path_factory.mktemp("dirs")
    vocab = make_test_vocab(trees["jcfg"].vocab_size)
    hcfg, _ = tiny_cfgs(timestamp=True, hotword=True)
    hw = jhw.init(jax.random.PRNGKey(5), jconfig.HotwordConfig(
        vocab_size=64, embed_dim=32, hidden_dim=64))
    hw = jax.tree.map(np.asarray, {"embed": hw["embed"], "lstm": hw["lstm"]})
    jzoo.save_offline_bundle(str(tmp / "hw"), dict(
        jax_params(hcfg, 0), hotword_compiler=hw), hcfg, vocab.tokens)
    (tmp / "hw" / "seg_dict").write_text(
        f"hello\t{vocab.id2token(12)} {vocab.id2token(13)}\n",
        encoding="utf-8")
    jzoo.save_offline_bundle(str(tmp / "asr"), trees["asr"], trees["jcfg"],
                             vocab.tokens)
    cmvn = (np.full(560, -10.0, np.float32), np.full(560, 0.3, np.float32))
    jzoo.save_svs_bundle(str(tmp / "svs"), svs_tree(2, seed=4),
                         jconfig.sensevoice_tiny(), vocab.tokens, cmvn)
    model_zoo.save_vad_dir(str(tmp / "vad"), params_from_jax(trees["vad"]),
                           tconfig.VadConfig())
    model_zoo.save_punc_dir(str(tmp / "punc"), params_from_jax(trees["punc"]),
                            tconfig.punc_tiny(300), PUNC_TOKENS)
    common = ["--vad-dir", str(tmp / "vad"), "--punc-dir", str(tmp / "punc"),
              "--device", "cpu"]
    out = {}
    for name, argv in (("hotword", ["--model-dir", str(tmp / "hw")]),
                       ("svs", ["--model-dir", str(tmp / "asr"),
                                "--svs-dir", str(tmp / "svs")])):
        port = build_models(parser().parse_args(argv + common))
        jb = jzoo.load_offline_bundle(argv[1])
        jm = JServerModels(
            asr_params=jb.params, asr_cfg=jb.cfg, vocab=jb.vocab,
            vad_params=trees["vad"], vad_cfg=jconfig.VadConfig(),
            punc_params=trees["punc"], punc_cfg=jconfig.punc_tiny(300),
            punc_tokenizer=JTokenizer(PUNC_TOKENS), itn=JITN())
        if name == "hotword":
            jm.hotword_params = jb.params["hotword_compiler"]
            jm.hotword_cfg = jconfig.HotwordConfig()
            jm.seg_dict = jhw.SegDict(str(tmp / "hw" / "seg_dict"))
        else:
            sb = jzoo.load_svs_bundle(str(tmp / "svs"))
            jm.svs_params, jm.svs_cfg = sb.params, sb.cfg
            jm.svs_vocab, jm.svs_cmvn = sb.vocab, sb.cmvn
        out[name] = (port, jm)
    return out


_DIR_REPLAYS = {
    "2pass": ("2pass", {}), "offline": ("offline", {}),
    "engine": ("2pass", dict(use_engine=True, engine_capacity=4)),
}


def _replay_both(pair, case, seconds, seed, on_serving=None, **fields):
    """The reference client's replay against the port's server and the
    JAX server; on_serving() runs once the port's server (and its
    engine's warmup) is up, before the client connects."""
    mode, kw = _DIR_REPLAYS[case]
    audio = _pcm(seconds, seed)
    msgs = {}
    for name, cls, m in (("port", AsrWsServer, pair[0]),
                         ("jax", JAsrWsServer, pair[1])):
        async def replay(server, port, name=name):
            if on_serving is not None and name == "port":
                on_serving()
            return await _reference_replay(port, mode, "w", audio, **fields)

        msgs[name] = _serve(m, replay, server_cls=cls, **kw)
    return msgs


@pytest.mark.parametrize("case", list(_DIR_REPLAYS))
def test_replay_with_hotwords_matches_jax(dir_models, case, monkeypatch):
    """The deployed hotword model served from its dir, with and without
    the engine: first-message hotwords compile into embeddings (one word
    through the seg_dict) and the finals, timestamps and partials equal
    the JAX server's. Every pass-2 forward of the hotworded connection
    carries its 4 embedding rows (null + 3 words); without hotwords none
    does."""
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    rows = []
    fwd = ParaformerOffline._forward

    def spy(self, feats, lens, hw_batch=None, hw_lens=None):
        if any(lens):
            rows.append(None if hw_batch is None else hw_lens[0])
        return fwd(self, feats, lens, hw_batch, hw_lens)

    monkeypatch.setattr(ParaformerOffline, "_forward", spy)
    t = dir_models["hotword"][0].vocab.id2token
    for hot, want_rows in ((json.dumps({t(10) + t(11): 20, "hello": 30,
                                        t(40): 20}), 4), ("", None)):
        msgs = _replay_both(dir_models["hotword"], case, 2.4, 11,
                            on_serving=rows.clear, hotwords=hot)
        got = _summary(msgs["port"])
        assert got == _summary(msgs["jax"])
        assert got[1] and all(ts for _, _, ts in got[1])
        assert rows and set(rows) == {want_rows}


@pytest.mark.parametrize("case", list(_DIR_REPLAYS))
def test_replay_with_svs_dir_matches_jax(dir_models, case):
    """--svs-dir: pass 2 (2pass finals and offline uploads) through
    SenseVoice with the connection's svs_lang and svs_itn, equal to the
    JAX server's; the first message's hotwords bias SenseVoice through a
    context graph."""
    t = dir_models["svs"][0].vocab.id2token
    msgs = _replay_both(dir_models["svs"], case, 2.4, 12, svs_lang="en",
                        svs_itn=False,
                        hotwords=json.dumps({t(7) + t(8): 40}))
    got = _summary(msgs["port"])
    assert got == _summary(msgs["jax"])
    assert got[1] and any(text for _, text, _ in got[1])
    finals = [m for m in msgs["port"] if m["is_final"]]
    assert finals and finals[-1] is msgs["port"][-1]


# -- tests/test_server.py on the port ---------------------------------------

async def _run_client(port, mode, pcm, chunk_ms=600):
    import websockets

    msgs = []
    async with websockets.connect(f"ws://127.0.0.1:{port}",
                                  max_size=1 << 30) as ws:
        await ws.send(json.dumps({
            "mode": mode, "chunk_size": [5, 10, 5], "chunk_interval": 10,
            "audio_fs": 16000, "wav_name": "t", "wav_format": "pcm",
            "is_speaking": True, "hotwords": "", "itn": True,
        }))
        stride = int(chunk_ms / 1000 * 16000 * 2)
        for i in range(0, len(pcm), stride):
            await ws.send(pcm[i: i + stride])
        await ws.send(json.dumps({"is_speaking": False}))
        while True:
            msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=120))
            msgs.append(msg)
            if msg.get("is_final"):
                break
    return msgs


@pytest.mark.parametrize("mode,engine", [("offline", False),
                                         ("2pass", False),
                                         ("online", False),
                                         ("2pass", True),
                                         ("online", True)])
def test_mode_roundtrip(models, mode, engine):
    """offline: one final with text; 2pass (per-connection session or the
    engine): partials, a pass-2 final, then is_final; online (session or
    engine): online partials only, then is_final. (The JAX engine serves
    an online connection as 2pass; the port's engine slot takes the
    connection's mode.)"""
    kw = dict(use_engine=True, engine_capacity=4) if engine else {}
    msgs = _serve(models, lambda s, port: _run_client(
        port, mode, _pcm(2.5, seed=1 + engine)), **kw)
    modes = {m.get("mode") for m in msgs}
    assert msgs[-1]["is_final"] is True
    if mode == "offline":
        assert len(msgs) == 1 and msgs[0]["mode"] == "offline"
        assert msgs[0]["wav_name"] == "t" and msgs[0]["text"]
    elif mode == "online":
        assert modes == {"online"}
        assert any(m.get("text") for m in msgs)
    else:
        assert {"2pass-online", "2pass-offline"} <= modes


def test_parse_hotwords_forms():
    assert _parse_hotwords('{"阿里巴巴": 20}') == {"阿里巴巴": 20}
    assert _parse_hotwords("w1 w2") == {"w1": 20, "w2": 20}
    assert _parse_hotwords({"x": 5}) == {"x": 5}
    assert _parse_hotwords('["a","b"]') == {"a": 20, "b": 20}
    assert _parse_hotwords("") == {}


def test_parse_hotwords_malformed_scores():
    assert _parse_hotwords({"w": "high"}) == {"w": 20}
    assert _parse_hotwords({"w": None, "v": 7}) == {"w": 20, "v": 7}
    assert _parse_hotwords('{"w": "x", "v": 3}') == {"w": 20, "v": 3}


def test_engine_at_capacity_error_json(models):
    """Connection capacity+1 gets a protocol error result (is_final +
    error) instead of a dropped socket; its remaining frames are dropped,
    the socket survives, and the first connection completes."""
    import websockets

    async def run(server, port):
        uri = f"ws://127.0.0.1:{port}"
        cfg = json.dumps({
            "mode": "2pass", "chunk_size": [5, 10, 5],
            "chunk_interval": 10, "audio_fs": 16000, "wav_name": "w1",
            "wav_format": "pcm", "is_speaking": True,
        })
        pcm = _pcm(0.6, seed=4)
        async with websockets.connect(uri) as ws1:
            await ws1.send(cfg)
            await ws1.send(pcm)
            deadline = asyncio.get_running_loop().time() + 30
            while (not any(s.active for s in server.engine.slots)
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.02)
            assert any(s.active for s in server.engine.slots)
            async with websockets.connect(uri) as ws2:
                await ws2.send(cfg)
                await ws2.send(pcm)
                msg = json.loads(
                    await asyncio.wait_for(ws2.recv(), timeout=30))
                assert msg["is_final"] is True
                assert "capacity" in msg.get("error", "")
                await ws2.send(pcm)
                await ws2.send(pcm)
                await ws2.send(json.dumps({"is_speaking": False}))
                with pytest.raises(asyncio.TimeoutError):
                    await asyncio.wait_for(ws2.recv(), timeout=1.0)
                await ws2.send(json.dumps({"action": "stats"}))
                reply = json.loads(
                    await asyncio.wait_for(ws2.recv(), timeout=30))
                assert "stats" in reply
            await ws1.send(json.dumps({"is_speaking": False}))
            while True:
                m = json.loads(await asyncio.wait_for(ws1.recv(),
                                                      timeout=120))
                if m.get("is_final"):
                    return m

    final = _serve(models, run, use_engine=True, engine_capacity=1)
    assert final["is_final"] is True
    assert "error" not in final


def test_engine_loop_survives_poisoned_tick(models):
    """One exception inside engine.step() does not kill the loop task:
    serving continues and the client still gets its results."""
    async def run(server, port):
        real = server.engine.step
        state = {"n": 0}

        def flaky():
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("poisoned tick")
            real()

        server.engine.step = flaky
        msgs = await _run_client(port, "2pass", _pcm(2.5, seed=9))
        assert state["n"] > 1
        return msgs

    msgs = _serve(models, run, use_engine=True, engine_capacity=4)
    modes = {m.get("mode") for m in msgs}
    assert "2pass-online" in modes or "2pass-offline" in modes
    assert msgs[-1]["is_final"] is True


def test_stats_protocol_extension(models):
    async def run(server, port):
        import websockets

        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await ws.send(json.dumps({"action": "stats"}))
            return json.loads(await asyncio.wait_for(ws.recv(), timeout=30))

    msg = _serve(models, run)
    assert "stats" in msg and "uptime_s" in msg["stats"]


def test_connection_records(models):
    """Each connection's record: its id and name, its engine slot, every
    audio message's arrival with the stream's sample count after it, and
    a send with its wait (>= 0, from the arrival of the message holding
    the audio it answers) for every partial and final the client got;
    the waits are stages and the engine's counters count, in stats."""
    pcm = _pcm(2.5, seed=4)

    async def run(server, port):
        import websockets

        from asr2pass_tpu_torch.runtime.metrics import GLOBAL

        GLOBAL.reset()      # the process's metrics: this connection's only
        got = await _run_client(port, "2pass", pcm, chunk_ms=60)
        for _ in range(500):        # the server sees the close
            if server.connection_records()[0]["closed"] is not None:
                break
            await asyncio.sleep(0.01)
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await ws.send(json.dumps({"action": "stats"}))
            stats = json.loads(await asyncio.wait_for(ws.recv(), 30))
        return got, server.connection_records(), stats["stats"]

    msgs, records, stats = _serve(models, run, use_engine=True,
                                  engine_capacity=4)
    rec = records[0]
    assert [r["id"] for r in records] == [1, 2]
    assert rec["wav_name"] == "t" and rec["engine_slot"] is not None
    n = len(pcm) // 2
    assert rec["samples"] == [min(k, n) for k in range(960, n + 960, 960)]
    assert rec["arrived"] == sorted(rec["arrived"])
    assert rec["opened"] <= rec["arrived"][0] <= rec["closed"]
    n_partial = sum(m["mode"] == "2pass-online" for m in msgs)
    n_final = sum(m["mode"] == "2pass-offline" for m in msgs)
    assert n_partial and n_final
    assert len(rec["partials"]) == n_partial
    assert len(rec["finals"]) == n_final
    for sent, wait, *end in rec["partials"] + rec["finals"]:
        assert 0 <= wait and sent <= rec["closed"]
    assert 0 < rec["finals"][-1][2] <= n
    assert stats["connections"] == {"opened": 2, "open": 1}
    assert stats["stages"]["ws.partial_wait"]["count"] == n_partial
    assert stats["stages"]["ws.final_wait"]["count"] == n_final
    counts = stats["counts"]
    assert counts["engine.p1_rows"] == 4 * counts["engine.p1_steps"]
    assert 0 < counts["engine.p1_active"] <= counts["engine.p1_rows"]
    assert counts["engine.p2_segments"] == n_final
    assert 0 < counts["engine.p2_audio_ms"] <= 2500


async def _offline_upload(port, pcm, step, wav_name="big"):
    import websockets

    async with websockets.connect(f"ws://127.0.0.1:{port}",
                                  max_size=None) as ws:
        await ws.send(json.dumps({"mode": "offline", "wav_name": wav_name,
                                  "wav_format": "pcm", "is_speaking": True}))
        for i in range(0, len(pcm), step):
            await ws.send(pcm[i: i + step])
        return json.loads(await asyncio.wait_for(ws.recv(), timeout=30))


def test_offline_upload_size_policy(models):
    """Oversize offline uploads get an error final instead of unbounded
    buffering."""
    msg = _serve(models, lambda s, port: _offline_upload(
        port, _pcm(2.0), 16000), max_upload_bytes=32000)
    assert msg["is_final"] is True
    assert "error" in msg and "max_upload_bytes" in msg["error"]


def test_offline_upload_rejection_is_sticky(models):
    """After the cap trips, trailing frames are dropped and the final
    message re-answers with the error; the next config JSON resets."""
    async def run(server, port):
        import websockets

        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await ws.send(json.dumps({
                "mode": "offline", "wav_name": "big",
                "wav_format": "pcm", "is_speaking": True}))
            pcm = _pcm(2.0)
            for i in range(0, len(pcm), 16000):
                await ws.send(pcm[i: i + 16000])
            first = json.loads(await asyncio.wait_for(ws.recv(), timeout=30))
            await ws.send(pcm[:16000])
            await ws.send(json.dumps({"is_speaking": False}))
            second = json.loads(await asyncio.wait_for(ws.recv(),
                                                       timeout=30))
            await ws.send(json.dumps({
                "mode": "offline", "wav_name": "ok", "wav_format": "pcm",
                "is_speaking": True}))
            await ws.send(_pcm(0.5))
            await ws.send(json.dumps({"is_speaking": False}))
            third = json.loads(await asyncio.wait_for(ws.recv(), timeout=60))
            return first, second, third

    first, second, third = _serve(models, run, max_upload_bytes=32000)
    assert "error" in first and "error" in second
    assert second["text"] == ""
    assert third["wav_name"] == "ok" and "error" not in third


def test_offline_single_frame_over_message_cap(models):
    """A single frame over max_message_bytes gets a graceful error
    result, not a transport close."""
    msg = _serve(models, lambda s, port: _offline_upload(
        port, _pcm(1.0), 32000, "oneframe"),
        max_message_bytes=16000, max_upload_bytes=64000)
    assert msg["is_final"] is True
    assert "error" in msg and "max_message_bytes" in msg["error"]


def test_offline_recognizer_cached_reuse(models):
    """Same options return the SAME recognizer; the cache is LRU-bounded."""
    a = models.offline_recognizer_cached(vad_tail_sil=800)
    b = models.offline_recognizer_cached(vad_tail_sil=800)
    c = models.offline_recognizer_cached(vad_tail_sil=500)
    h = models.offline_recognizer_cached(hotwords={"你好": 20})
    assert a is b
    assert c is not a and h is not a
    # the recognizers share the server's one model on the device
    assert a.asr.model is c.asr.model is models.asr_params
    for i in range(40):
        models.offline_recognizer_cached(hotwords={f"w{i}": 20},
                                         max_cached=8)
    assert len(models._offline_rec_cache) <= 8


def test_malformed_first_message_fields_survive(models):
    """Malformed option types in the first JSON get ONE protocol error
    result, degrade to defaults, and the SAME socket then serves a clean
    utterance."""
    import websockets

    async def run(server, port):
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=1 << 30) as ws:
            await ws.send(json.dumps({
                "mode": "sideways", "audio_fs": "not-a-number",
                "hotwords": {"词": "high"}, "vad_tail_sil": "xx",
                "vad_max_len": [1, 2], "itn": "yes", "wav_name": 3,
                "is_speaking": True,
            }))
            ack = json.loads(await asyncio.wait_for(ws.recv(), timeout=30))
            assert ack["is_final"] is False
            assert "mode" in ack["error"] and "audio_fs" in ack["error"]
            await ws.send(_pcm(1.2, seed=33))
            await ws.send(json.dumps({"is_speaking": False}))
            while True:
                m = json.loads(await asyncio.wait_for(ws.recv(),
                                                      timeout=120))
                if m.get("is_final"):
                    return m

    assert _serve(models, run)["mode"] == "2pass"


def test_offline_upload_does_not_stall_engine_tick(models):
    """In engine mode a whole-file offline decode runs on its OWN
    executor: live 2pass streams keep emitting partials while the upload
    decodes."""
    import websockets

    async def run(server, port):
        assert server._offline_executor is not None
        loop = asyncio.get_running_loop()
        started = asyncio.Event()
        real = server._offline_decode

        def slow(st):
            loop.call_soon_threadsafe(started.set)
            time.sleep(4.0)          # a long decode occupying its worker
            return real(st)

        server._offline_decode = slow
        uri = f"ws://127.0.0.1:{port}"
        async with websockets.connect(uri, max_size=1 << 30) as off:
            async with websockets.connect(uri) as live:
                await live.send(json.dumps({
                    "mode": "2pass", "wav_format": "pcm",
                    "audio_fs": 16000, "wav_name": "live",
                    "is_speaking": True}))
                await off.send(json.dumps({
                    "mode": "offline", "wav_format": "pcm",
                    "audio_fs": 16000, "wav_name": "up",
                    "is_speaking": True}))
                await off.send(_pcm(2.0, seed=21))
                await off.send(json.dumps({"is_speaking": False}))
                await asyncio.wait_for(started.wait(), timeout=60)
                pcm = _pcm(6.0, seed=22)
                stride = int(0.6 * 16000 * 2)
                got_partial = False
                deadline = loop.time() + 3.5   # inside the sleep window
                i = 0
                while loop.time() < deadline and not got_partial:
                    await live.send(pcm[i: i + stride])
                    i = (i + stride) % (len(pcm) - stride)
                    try:
                        m = json.loads(await asyncio.wait_for(
                            live.recv(), timeout=0.6))
                        got_partial = bool(m.get("text"))
                    except asyncio.TimeoutError:
                        pass
                assert got_partial, \
                    "no live partial while an offline upload decoded"
            while True:
                m = json.loads(await asyncio.wait_for(off.recv(),
                                                      timeout=120))
                if m.get("is_final"):
                    return m

    final = _serve(models, run, use_engine=True, engine_capacity=4)
    assert final["mode"] == "offline"


def test_per_connection_chunk_size_honored(models):
    """The first message's chunk_size plumbs into the session's online
    config; malformed values degrade with the usual error ack."""
    sess = models.create_session(mode="2pass", chunk_size=[4, 8, 4])
    assert tuple(sess.online_asr.cfg.chunk_size) == (4, 8, 4)
    assert tuple(models.create_session(mode="2pass").online_asr.cfg
                 .chunk_size) == tuple(models.asr_cfg.chunk_size)

    async def run(server, port):
        import websockets

        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            await ws.send(json.dumps({
                "mode": "2pass", "chunk_size": [4, 8, "x"],
                "wav_format": "pcm", "audio_fs": 16000,
                "is_speaking": True}))
            ack = json.loads(await asyncio.wait_for(ws.recv(), timeout=30))
            assert "chunk_size" in ack.get("error", "")
            await ws.send(_pcm(1.2, seed=55))
            await ws.send(json.dumps({"is_speaking": False}))
            while True:
                m = json.loads(await asyncio.wait_for(ws.recv(),
                                                      timeout=120))
                if m.get("is_final"):
                    return m

    assert _serve(models, run)["is_final"] is True


def test_engine_many_concurrent_clients(models):
    """12 concurrent clients through one engine: every connection gets
    exactly one final, last; wav_names never cross-deliver; the engine
    drains clean."""
    import websockets

    async def one(port, i):
        pcm = _pcm(1.2 + 0.1 * (i % 4), seed=100 + i)
        name = f"c{i}"
        msgs = []
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=1 << 30) as ws:
            await ws.send(json.dumps({
                "mode": "2pass", "wav_name": name, "wav_format": "pcm",
                "audio_fs": 16000, "is_speaking": True}))
            stride = int(0.6 * 16000 * 2)
            for off in range(0, len(pcm), stride):
                await ws.send(pcm[off: off + stride])
                await asyncio.sleep(0.01)
            await ws.send(json.dumps({"is_speaking": False}))
            while True:
                m = json.loads(await asyncio.wait_for(ws.recv(),
                                                      timeout=180))
                msgs.append(m)
                if m.get("is_final"):
                    return name, msgs

    async def run(server, port):
        res = await asyncio.gather(*[one(port, i) for i in range(12)])
        for sid in range(server.engine.capacity):
            assert server.engine.drained(sid)
        return res

    results = _serve(models, run, use_engine=True, engine_capacity=16)
    assert len(results) == 12
    for name, msgs in results:
        assert all(m["wav_name"] == name for m in msgs)
        finals = [m for m in msgs if m.get("is_final")]
        assert len(finals) == 1 and msgs[-1] is finals[0]


def test_engine_and_server_run_on_the_models_device(models):
    """The engine's device buffers and the server's engine live on the
    ServerModels' device; websockets is imported only by serve()."""
    import subprocess
    import sys

    async def run(server, port):
        return server.engine

    eng = _serve(models, run, use_engine=True, engine_capacity=2)
    assert eng._audio_ring.device == models.device == torch.device("cpu")
    assert eng.online_state.dec_caches.device == models.device
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, asr2pass_tpu_torch.server.ws_server, "
         "asr2pass_tpu_torch.server.run_server; "
         "print('websockets' in sys.modules)"],
        capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "False", res.stderr


# -- the launcher -------------------------------------------------------------

def test_build_models_from_model_dirs(trees, models, tmp_path):
    """Saved tiny model dirs -> build_models: the same configs, weights
    and recognizer output as models built directly, ITN on by default
    and off with --no-itn."""
    tcfg = trees["tcfg"]
    model_zoo.save_offline_bundle(
        str(tmp_path / "asr"), models.asr_params, tcfg,
        models.vocab.tokens)
    vad_cfg = tconfig.VadConfig()
    model_zoo.save_vad_dir(str(tmp_path / "vad"), models.vad_params, vad_cfg)
    model_zoo.save_punc_dir(str(tmp_path / "punc"), models.punc_params,
                            tconfig.punc_tiny(300), PUNC_TOKENS)
    argv = ["--model-dir", str(tmp_path / "asr"),
            "--online-model-dir", str(tmp_path / "asr"),
            "--vad-dir", str(tmp_path / "vad"),
            "--punc-dir", str(tmp_path / "punc"), "--device", "cpu"]
    built = build_models(parser().parse_args(argv))
    assert isinstance(built.itn, ChineseITN)
    assert built.device == torch.device("cpu")
    assert (built.asr_cfg, built.vad_cfg) == (tcfg, vad_cfg)
    assert built.online_params is not None
    wave = (np.frombuffer(_pcm(2.0, 8), "<i2") / 32768.0).astype(np.float32)
    ref = models.create_offline_recognizer().transcribe(wave)
    got = built.create_offline_recognizer().transcribe(wave, use_itn=False)
    assert got == ref and got.text
    assert build_models(parser().parse_args(argv + ["--no-itn"])).itn is None
    demo = build_models(parser().parse_args(["--demo", "--device", "cpu"]))
    assert demo.vad_params is not None and demo.punc_params is not None
    with pytest.raises(SystemExit):
        build_models(parser().parse_args(["--device", "cpu"]))
