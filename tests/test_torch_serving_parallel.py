"""Serving on several ranks (the port's server/fanout.py, the launcher's
--tp-devices and --sp-devices, the fleet supervisor) on the CPU, in gloo
groups of spawned processes (tests/torch_parallel_workers.py, one spawn
at a time), against the JAX package's multi-device serving
(tests/test_multichip_serving.py, tests/test_multihost.py:157).

Model dirs are saved from the JAX `init` of tiny configs with 2 heads
(paraformer_tiny with the timestamp head, its hotword variant with a
converted compiler, sensevoice_tiny, VadConfig(), punc_tiny(300)), read
by both packages; audio is made with numpy from a seed. At tp 2 the TP
forward sums its row-parallel partial products in another order than
the unsharded one (tests/test_torch_parallel.py holds its logits to
1e-4); here, as there, the texts, timestamps and partials that come out
must be equal to the JAX server's with tp_mesh=make_mesh(8, tp=2), and
the SP upload to JAX's sp_mesh recognizer's.
"""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import hotword as jhw
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.models import ct_transformer as jct
from asr2pass_tpu.parallel.sharding import make_mesh as jmake_mesh
from asr2pass_tpu.runtime import engine as jengine
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.server.engine import ServerModels as JServerModels
from asr2pass_tpu.text.itn import ChineseITN as JITN
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.runtime import model_zoo
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.server import run_all_servers as ras
from torch_parallel_workers import (REPO, engine_results, session_results,
                                    spawn, spawn_lock, upload_result)
from torch_parity import (bursty, jax_params, lm_test_dirs, speechy,
                          svs_tree, tiny_cfgs)

sys.path.insert(0, str(REPO / "scripts"))
import run_all_servers as jras  # noqa: E402

sys.path.pop(0)

PUNC_TOKENS = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]
VOCAB = make_test_vocab(64)
TP = 2
LM_WEIGHT = "1.5"        # strong enough that the LM changes the texts
SP_THRESHOLD = 64        # LFR frames: 3.84 s
SERVER_TIMEOUT_S = 120   # a launcher's server to come up, or a reply


def _waves():
    """wave0-2: bursts of 1-2 s between silences (wave2's one VAD segment
    below SP_THRESHOLD); long: one 6 s burst (past it)."""
    return {"wave0": bursty([(0.3, False), (1.5, True), (0.8, False),
                             (1.2, True), (0.8, False)], 3),
            "wave1": bursty([(0.4, False), (1.8, True), (0.9, False),
                             (1.4, True), (0.9, False)], 4),
            "wave2": bursty([(0.2, False), (2.0, True), (1.0, False)], 5),
            "long": bursty([(0.3, False), (6.0, True), (0.8, False)], 6)}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Model dirs both packages read: "hw" a converted hotword model
    (paraformer_tiny with timestamps and the hotword block, its compiler
    without a null row, a seg_dict), "asr" paraformer_tiny with
    timestamps, "svs" sensevoice_tiny, "vad", "punc"; "ctc" a TLG graph
    with the CTC topology over the test vocabulary's units; and the
    launcher's flags of each server config."""
    tmp = tmp_path_factory.mktemp("dirs")
    hcfg, _ = tiny_cfgs(timestamp=True, hotword=True)
    jcfg, _ = tiny_cfgs(timestamp=True)
    hw = jhw.init(jax.random.PRNGKey(5), jconfig.HotwordConfig(
        vocab_size=64, embed_dim=32, hidden_dim=64))
    hw = jax.tree.map(np.asarray, {"embed": hw["embed"], "lstm": hw["lstm"]})
    jzoo.save_offline_bundle(str(tmp / "hw"), dict(
        jax_params(hcfg, 0), hotword_compiler=hw), hcfg, VOCAB.tokens)
    (tmp / "hw" / "seg_dict").write_text(
        f"hello\t{VOCAB.id2token(12)} {VOCAB.id2token(13)}\n",
        encoding="utf-8")
    jzoo.save_offline_bundle(str(tmp / "asr"), jax_params(jcfg, 0), jcfg,
                             VOCAB.tokens)
    cmvn = (np.full(560, -10.0, np.float32), np.full(560, 0.3, np.float32))
    jzoo.save_svs_bundle(str(tmp / "svs"), svs_tree(0, seed=4),
                         jconfig.sensevoice_tiny(), VOCAB.tokens, cmvn)
    vad = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                             jconfig.VadConfig()))
    punc = jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(2),
                                             jconfig.punc_tiny(300)))
    model_zoo.save_vad_dir(str(tmp / "vad"), params_from_jax(vad),
                           tconfig.VadConfig())
    model_zoo.save_punc_dir(str(tmp / "punc"), params_from_jax(punc),
                            tconfig.punc_tiny(300), PUNC_TOKENS)
    (tmp / "lm").mkdir()
    lm = lm_test_dirs(tmp / "lm")
    common = ["--vad-dir", str(tmp / "vad"), "--punc-dir", str(tmp / "punc")]
    svs = ["--model-dir", str(tmp / "asr"), "--svs-dir", str(tmp / "svs")]
    argv = {"hotword": ["--model-dir", str(tmp / "hw")] + common,
            "asr": ["--model-dir", str(tmp / "asr")] + common,
            "svs": svs + common,
            "tlg": svs + common + ["--lm-dir", lm["ctc"], "--lm-weight",
                                   LM_WEIGHT]}
    return dict(tmp=tmp, vad=vad, punc=punc, argv=argv, ctc=lm["ctc"])


def _jax_models(dirs, name, **kw):
    """JAX's ServerModels of one server config, from the same dirs."""
    tmp = dirs["tmp"]
    jb = jzoo.load_offline_bundle(str(tmp / ("hw" if name == "hotword"
                                             else "asr")))
    jm = JServerModels(
        asr_params=jb.params, asr_cfg=jb.cfg, vocab=jb.vocab,
        vad_params=dirs["vad"], vad_cfg=jconfig.VadConfig(),
        punc_params=dirs["punc"], punc_cfg=jconfig.punc_tiny(300),
        punc_tokenizer=JTokenizer(PUNC_TOKENS), itn=JITN(), **kw)
    if name == "hotword":
        jm.hotword_params = jb.params["hotword_compiler"]
        jm.hotword_cfg = jconfig.HotwordConfig()
        jm.seg_dict = jhw.SegDict(str(tmp / "hw" / "seg_dict"))
    if name in ("svs", "tlg"):
        sb = jzoo.load_svs_bundle(str(tmp / "svs"))
        jm.svs_params, jm.svs_cfg = sb.params, sb.cfg
        jm.svs_vocab, jm.svs_cmvn = sb.vocab, sb.cmvn
    if name == "tlg":
        jm.tlg_dir, jm.lm_weight = dirs["ctc"], float(LM_WEIGHT)
    return jm


def _hotwords():
    t = VOCAB.id2token
    return {t(10) + t(11): 20, "hello": 30, t(40): 20}


@pytest.fixture(scope="module")
def tp_serving(dirs, tmp_path_factory):
    """The three server configs of case_serving_tp at tp 2 on 2 ranks,
    and JAX's ServerModels(tp_mesh=make_mesh(8, tp=2)) on the same
    requests."""
    waves = _waves()
    svs_hot = {VOCAB.id2token(7) + VOCAB.id2token(8): 60}
    outs = spawn("serving_tp", tmp_path_factory.mktemp("tp"), TP, waves,
                 {"argv": dirs["argv"], "hotwords": _hotwords(),
                  "svs_hotwords": svs_hot})
    mesh = jmake_mesh(8, tp=TP)
    hot = _hotwords()
    jm = _jax_models(dirs, "hotword", tp_mesh=mesh)
    ref = {"upload": upload_result(jm.create_offline_recognizer(),
                                   waves["wave0"]),
           "session": session_results(jm.create_session(), waves["wave1"]),
           "hotword": session_results(jm.create_session(
               hw_emb=jm.compile_hotwords(hot), hotwords=hot),
               waves["wave1"]),
           "engine": engine_results(
               jengine.StreamEngine(jm, capacity=4, fused_fetch=True,
                                    pass2_async=True),
               [waves["wave0"], waves["wave1"]],
               [{}, dict(hw_emb=jm.compile_hotwords(hot), hotwords=hot)]),
           "threads": [upload_result(jm.create_offline_recognizer(),
                                     waves[w]) for w in ("wave2", "wave1")]}
    js = _jax_models(dirs, "svs", tp_mesh=mesh)
    ref["context"] = session_results(js.create_session(
        use_svs=True, svs_lang="zh", hotwords=svs_hot), waves["wave1"])
    ref["svs_upload"] = upload_result(js.create_offline_recognizer(
        use_svs=True, svs_lang="en"), waves["wave0"])
    jt = _jax_models(dirs, "tlg", tp_mesh=mesh)
    ref["tlg"] = session_results(jt.create_session(use_svs=True),
                                 waves["wave1"])
    # the same session without the LM: the graph must change the text
    ref["no_tlg"] = session_results(js.create_session(use_svs=True),
                                    waves["wave1"])
    return [o["json"] for o in outs], ref


def _nonempty(r):
    return r["finals"] and all(text for text, _ in r["finals"])


def test_tp_upload_matches_jax(tp_serving):
    """An offline upload through the fan-out (VAD, pass 2 at tp 2,
    punctuation, ITN, timestamps on rank 0): JAX's text and timestamps."""
    got, ref = tp_serving
    assert got[0]["hotword"]["upload"] == ref["upload"]
    assert ref["upload"][0] and ref["upload"][1]


def test_tp_session_matches_jax(tp_serving):
    """A 2pass session: its partials and finals with timestamps."""
    got, ref = tp_serving
    assert got[0]["hotword"]["session"] == ref["session"]
    assert ref["session"]["partial"] and _nonempty(ref["session"])


def test_tp_hotword_session_matches_jax(tp_serving):
    """A hotworded Paraformer connection: the embeddings ride in the call
    to the worker."""
    got, ref = tp_serving
    assert got[0]["hotword"]["hotword"] == ref["hotword"]
    assert _nonempty(ref["hotword"])


def test_tp_engine_matches_jax(tp_serving):
    """A StreamEngine with its pass-2 lane and ring (the ring's features
    broadcast to the worker), two streams, one hotworded."""
    got, ref = tp_serving
    assert got[0]["hotword"]["engine"] == ref["engine"]
    assert all(r["partial"] and _nonempty(r) for r in ref["engine"])


def test_tp_concurrent_calls_are_ordered(tp_serving):
    """Two rank-0 threads uploading at once: each gets what it gets
    alone, and JAX's."""
    got, ref = tp_serving
    j = got[0]["hotword"]
    assert j["threads"] == j["serial"] == ref["threads"]


def test_tp_svs_context_matches_jax(tp_serving):
    """A SenseVoice connection with a hotword context and svs_lang (the
    sharded prune; the context travels as its unit ids), and a
    SenseVoice upload."""
    got, ref = tp_serving
    assert got[0]["svs"]["context"] == ref["context"]
    assert got[0]["svs"]["upload"] == ref["svs_upload"]
    assert ref["context"]["finals"] and ref["svs_upload"][0]


def test_tp_svs_tlg_matches_jax(tp_serving):
    """A SenseVoice connection rescored by a TLG graph (the vocab gathered
    on every rank, the search on rank 0), and the graph changes it."""
    got, ref = tp_serving
    assert got[0]["tlg"]["tlg"] == ref["tlg"]
    assert ref["tlg"]["finals"] != ref["no_tlg"]["finals"]


def test_tp_shards_once_a_role(tp_serving):
    """Every session, the engine and the upload recognizers share one
    sharded module a role."""
    got, _ = tp_serving
    assert got[0]["hotword"]["shards"] == ["asr"]
    assert got[0]["hotword"]["shared"] is True
    assert got[0]["svs"]["shards"] == ["svs"]


def test_tp_ranks_issue_the_same_collectives(tp_serving):
    """The worker replays rank 0's calls: the same all-reduces,
    all-gathers and broadcasts on both ranks, in every config."""
    got, _ = tp_serving
    for name in ("hotword", "svs", "tlg"):
        c0, c1 = got[0][name]["collectives"], got[1][name]["collectives"]
        assert c0 == c1 and c0["all_reduce"] and c0["broadcast"]
        fan = got[0][name]["fanout"]
        assert fan["world"] == TP and fan["calls"] > 0
        assert c0["broadcast"] == fan["broadcasts"]


def test_sp_upload_matches_jax(dirs, tmp_path_factory):
    """--sp-devices 2 --sp-threshold 64: an upload past the threshold
    through the sequence-parallel encoder on both ranks equals JAX's
    sp_mesh recognizer's; one below it runs on rank 0 alone."""
    from jax.sharding import Mesh

    waves = _waves()
    outs = spawn("serving_sp", tmp_path_factory.mktemp("sp"), TP, waves,
                 {"argv": dirs["argv"], "sp_threshold": SP_THRESHOLD,
                  "max_len": 60000})
    jm = _jax_models(dirs, "asr", sp_mesh=Mesh(np.array(jax.devices()[:TP]),
                                               ("sp",)),
                     sp_threshold=SP_THRESHOLD)
    rec = jm.create_offline_recognizer(vad_max_len=60000)
    got = outs[0]["json"]
    assert got["long"] == upload_result(rec, waves["long"])
    assert got["short"] == upload_result(rec, waves["wave2"])
    assert got["long"][0]
    assert got["calls_long"] == 1 and got["calls_short"] == 0
    assert got["collectives"]["halo"] > 0
    assert got["collectives"] == outs[1]["json"]["collectives"]


def test_tp_sp_server_matches_jax(dirs, tmp_path_factory):
    """--tp-devices 2 --sp-devices 2 --sp-threshold 64 through the
    launcher's build_models (ServerModels with both meshes): the uploads
    past and below the threshold and an engine (the 6 s segment through
    the SP path from the lane, the short one through TP from the ring)
    equal JAX's ServerModels given tp_mesh=make_mesh(2, tp=2) and an
    sp_mesh over the same 2 devices."""
    from jax.sharding import Mesh

    waves = _waves()
    outs = spawn("serving_tpsp", tmp_path_factory.mktemp("tpsp"), TP, waves,
                 {"argv": dirs["argv"], "tp": TP, "sp": TP,
                  "sp_threshold": SP_THRESHOLD, "max_len": 60000})
    jm = _jax_models(dirs, "asr", tp_mesh=jmake_mesh(TP, tp=TP),
                     sp_mesh=Mesh(np.array(jax.devices()[:TP]), ("sp",)),
                     sp_threshold=SP_THRESHOLD)
    rec = jm.create_offline_recognizer(vad_max_len=60000)
    got = outs[0]["json"]
    assert got["meshes"] == [[1, TP], [1, TP]]
    assert got["long"] == upload_result(rec, waves["long"])
    assert got["short"] == upload_result(rec, waves["wave2"])
    assert got["long"][0] and got["short"][0]
    eng = jengine.StreamEngine(jm, capacity=2, fused_fetch=True,
                               pass2_async=True)
    eng.warmup()
    eng.warm_pass2_ring()
    assert got["engine"] == engine_results(eng, [waves["long"],
                                                 waves["wave2"]])
    assert all(_nonempty(r) for r in got["engine"])
    c = got["collectives"]
    assert c["halo"] > 0 and c["all_reduce"] > 0 and c["broadcast"] > 0
    assert c == outs[1]["json"]["collectives"]


def test_two_process_serving_dp(dirs, tmp_path_factory):
    """Two gloo processes, each its own StreamEngine on its own audio
    (tests/test_multihost.py:157): each text equals a fresh engine's in
    its process and the JAX engine's on that audio; the two differ."""
    waves = _waves()
    outs = spawn("serving_dp", tmp_path_factory.mktemp("dp"), 2,
                 {k: waves[k] for k in ("wave0", "wave1")},
                 {"argv": dirs["argv"]})
    jm = _jax_models(dirs, "asr")
    for rank, o in enumerate(outs):
        got = o["json"]["engine"]
        assert got == o["json"]["fresh"]
        assert got == engine_results(jengine.StreamEngine(jm, capacity=2),
                                     [waves[f"wave{rank}"]])[0]
        assert _nonempty(got)
    assert outs[0]["json"]["engine"] != outs[1]["json"]["engine"]


def test_fanout_fault_ends_both_ranks(dirs, tmp_path_factory):
    """A bad call is refused before anything is sent (the group stays
    usable); a rank-0 failure after a call went out ends rank 0 with
    FAULT_EXIT and the worker non-zero, well within the group's
    timeout."""
    from asr2pass_tpu_torch.server.fanout import FAULT_EXIT

    t0 = time.monotonic()
    res = spawn("serving_fault", tmp_path_factory.mktemp("fault"), TP,
                _waves(), {"argv": dirs["argv"]}, expect_fail=True)
    took = time.monotonic() - t0
    (rc0, log0), (rc1, log1) = res
    assert "refused before sending" in log0
    assert "calls before the fault: 0" in log0
    assert "injected failure after the send" in log0
    assert rc0 == FAULT_EXIT, log0[-3000:]
    assert rc1 not in (0, None), log1[-3000:]
    assert took < 100


# -- the launcher ------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))


def _wait_listening(proc, port, log_path):
    deadline = time.time() + SERVER_TIMEOUT_S
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"server exited {proc.returncode}:\n"
                f"{open(log_path).read()[-3000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.3)
    raise AssertionError("server never listened")


def _s16(wave) -> bytes:
    return (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()


async def _request(port, mode, wave):
    """The reference client's messages: first JSON, 600 ms frames, the
    end marker; every message until the final."""
    import websockets

    out = []
    pcm = _s16(wave)
    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(json.dumps({
            "mode": mode, "chunk_size": [5, 10, 5], "audio_fs": 16000,
            "wav_name": "w", "wav_format": "pcm", "is_speaking": True}))
        for i in range(0, len(pcm), 19200):
            await ws.send(pcm[i: i + 19200])
        await ws.send(json.dumps({"is_speaking": False}))
        while True:
            m = json.loads(await asyncio.wait_for(ws.recv(),
                                                  SERVER_TIMEOUT_S))
            out.append({k: m.get(k) for k in ("mode", "text", "timestamp",
                                              "is_final")})
            if m.get("is_final") or m.get("mode") == "offline":
                return out


async def _stats(port):
    import websockets

    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(json.dumps({"action": "stats"}))
        return json.loads(await asyncio.wait_for(ws.recv(),
                                                 SERVER_TIMEOUT_S))["stats"]


def _launch(tmp_path, name, flags):
    port = _free_port()
    log_path = tmp_path / f"{name}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "asr2pass_tpu_torch.server.run_server",
             "--demo", "--device", "cpu", "--host", "127.0.0.1", "--port",
             str(port), "--engine", "--engine-capacity", "4", *flags],
            cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT)
    return proc, port, log_path


def test_launcher_tp_serves_like_one_process(tmp_path):
    """run_server --demo --device cpu --tp-devices 2 (rank 0 and the
    worker it starts) serves a 2pass websocket round trip and an upload
    equal to --tp-devices 0 with the same seed; the worker is gone after
    SIGTERM."""
    wave = _waves()["wave0"]
    got = {}
    with spawn_lock(tmp_path):
        servers = {tp: _launch(tmp_path, f"tp{tp}", ["--tp-devices", tp])
                   for tp in ("0", "2")}
        try:
            for tp, (proc, port, log_path) in servers.items():
                _wait_listening(proc, port, log_path)
                got[tp] = [asyncio.run(_request(port, mode, wave))
                           for mode in ("2pass", "offline")]
                got[tp + "stats"] = asyncio.run(_stats(port))
        finally:
            for proc, _, _ in servers.values():
                proc.send_signal(signal.SIGTERM)
            rcs = {tp: proc.wait(timeout=60)
                   for tp, (proc, _, _) in servers.items()}
    for tp, (_, port, log_path) in servers.items():
        assert rcs[tp] == 0, open(log_path).read()[-3000:]
    assert got["2"] == got["0"]
    finals = [m for m in got["0"][0] if m["mode"] == "2pass-offline"]
    assert finals and all(m["text"] for m in finals)
    assert got["2"][1][0]["text"]
    fan = got["2stats"]["fanout"]
    assert fan["world"] == 2 and fan["calls"] >= 3 and fan["shards"] == [
        "asr"]
    assert "fanout" not in got["0stats"]
    assert not _running_with(f"--port\0{port}\0")


def _running_with(needle: str) -> list:
    """Pids whose command line holds `needle` (arguments NUL-joined)."""
    found = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    if needle.encode() in f.read():
                        found.append(int(d))
            except OSError:
                pass
    return found


def test_launcher_tp_with_sp_serves_like_one_process(tmp_path):
    """run_server --demo --device cpu --tp-devices 4 --sp-devices 2
    --sp-threshold 64 (4 ranks: tp 4 over the demo model's 2 heads, so
    its attention whole; sp over ranks 0-1 and over 2-3) answers an
    upload past the threshold and one below it as the --tp-devices 0
    server does; the worker ranks are gone after SIGTERM."""
    waves = _waves()
    flags = {"0": ["--tp-devices", "0"],
             "4x2": ["--tp-devices", "4", "--sp-devices", "2",
                     "--sp-threshold", str(SP_THRESHOLD)]}
    got = {}
    with spawn_lock(tmp_path):
        servers = {k: _launch(tmp_path, f"s{k}", f) for k, f in flags.items()}
        try:
            for k, (proc, port, log_path) in servers.items():
                _wait_listening(proc, port, log_path)
                got[k] = [asyncio.run(_request(port, "offline", waves[w]))
                          for w in ("long", "wave2")]
                got[k + "stats"] = asyncio.run(_stats(port))
        finally:
            for proc, _, _ in servers.values():
                proc.send_signal(signal.SIGTERM)
            rcs = {k: proc.wait(timeout=60)
                   for k, (proc, _, _) in servers.items()}
    for k, (_, port, log_path) in servers.items():
        assert rcs[k] == 0, open(log_path).read()[-3000:]
        assert not _running_with(f"--port\0{port}\0")
    assert got["4x2"] == got["0"]
    assert all(r[0]["text"] for r in got["0"])
    fan = got["4x2stats"]["fanout"]
    assert fan["world"] == 4 and fan["calls"] >= 2


@pytest.mark.parametrize("tp,sp", [("3", "2"), ("2", "3")])
def test_launcher_refuses_a_tp_sp_pair_that_does_not_divide(tp, sp):
    """--tp-devices and --sp-devices where neither count divides the
    other are refused, both counts named, before any rank starts (the
    JAX launcher takes any pair: ROADMAP, "Differences recorded")."""
    res = subprocess.run(
        [sys.executable, "-m", "asr2pass_tpu_torch.server.run_server",
         "--demo", "--device", "cpu", "--tp-devices", tp, "--sp-devices",
         sp], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=SERVER_TIMEOUT_S)
    assert res.returncode != 0
    assert f"--tp-devices {tp} with --sp-devices {sp}" in res.stderr


def test_launcher_tp_on_cuda_without_a_card_raises():
    """--tp-devices on --device cuda (the default) without a card raises
    before any rank starts: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-m", "asr2pass_tpu_torch.server.run_server",
         "--demo", "--tp-devices", "2"], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=SERVER_TIMEOUT_S)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "dist-rank" not in res.stderr


# -- the fleet supervisor ----------------------------------------------------

_ENTRY = {"name": "x", "port": 1, "mode": "2pass", "demo": True,
          "model_dir": "/m", "online_model_dir": "/o", "vad_dir": "/v",
          "punc_dir": "/p", "itn": True, "decode_workers": 2,
          "engine": True, "engine_capacity": 64, "upload_overlap": True,
          "decide_async": True, "svs_dir": "/s", "svs_beam": 4,
          "lm_dir": "/l", "hotword_file": "/h", "itn_dir": "/i",
          "tp_devices": 4, "sp_devices": 2}


def _flags(cmd):
    """{flag: value or True} of an argv after its program."""
    out, i, args = {}, 0, list(cmd)
    while i < len(args):
        a = args[i]
        if a.startswith("--"):
            nxt = args[i + 1] if i + 1 < len(args) else None
            if nxt is not None and not nxt.startswith("--"):
                out[a] = nxt
                i += 2
                continue
            out[a] = True
        i += 1
    return out


@pytest.mark.parametrize("key", sorted(set(_ENTRY) - {"name", "mode"}))
def test_build_cmd_maps_jax_keys(key):
    """Each key JAX's build_cmd maps reaches the port's launcher as the
    same flag with the same value (the JAX one's --cpu and --device K
    become --device cpu / cuda, below)."""
    entry = {"name": "x", "port": 1, key: _ENTRY[key]}
    jcmd, _ = jras.build_cmd(entry)
    cmd, _ = ras.build_cmd(entry)
    assert cmd[1:3] == ["-m", "asr2pass_tpu_torch.server.run_server"]
    assert _flags(cmd) == _flags(jcmd[2:])


def test_build_cmd_devices():
    """device: K masks the child to card K and passes --device cuda; a
    list or "0,1" gives a TP entry its cards; cpu: true passes --device
    cpu."""
    cmd, env = ras.build_cmd({"name": "x", "port": 1, "device": 2,
                              "tp_devices": 1})
    assert env["CUDA_VISIBLE_DEVICES"] == "2"
    assert _flags(cmd)["--device"] == "cuda"
    assert _flags(cmd)["--tp-devices"] == "1"
    _, env = ras.build_cmd({"name": "x", "port": 1, "device": "0,1"})
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1"
    cmd, env = ras.build_cmd({"name": "x", "port": 1, "cpu": True})
    assert _flags(cmd)["--device"] == "cpu"
    assert "CUDA_VISIBLE_DEVICES" not in env or \
        env["CUDA_VISIBLE_DEVICES"] == os.environ.get("CUDA_VISIBLE_DEVICES")


def test_build_cmd_passes_tp_with_sp():
    """A fleet entry holding tp_devices and sp_devices: both flags reach
    the port's launcher as JAX's build_cmd passes them, and the launcher
    takes them as 4 ranks."""
    from asr2pass_tpu_torch.server.run_server import parallel_world, parser

    entry = {"name": "x", "port": 1, "model_dir": "m", "device": "0,1,2,3",
             "tp_devices": 2, "sp_devices": 4}
    cmd, env = ras.build_cmd(entry)
    jcmd, _ = jras.build_cmd(entry)
    flags = _flags(cmd)
    assert flags["--tp-devices"] == "2" and flags["--sp-devices"] == "4"
    assert {k: flags[k] for k in ("--tp-devices", "--sp-devices")} == {
        k: _flags(jcmd[2:])[k] for k in ("--tp-devices", "--sp-devices")}
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    args = parser().parse_args(cmd[3:])
    assert parallel_world(args) == 4


def test_supervisor_restarts_a_killed_child(tmp_path):
    """run_all_servers on a --demo CPU entry: the child answers, is
    killed, is restarted once (within startretries) and answers again;
    SIGTERM stops the supervisor and leaves no child."""
    port = _free_port()
    cfg = tmp_path / "servers.yaml"
    cfg.write_text(f"servers:\n  - name: demo\n    port: {port}\n"
                   "    demo: true\n    cpu: true\n    engine: true\n"
                   "    engine_capacity: 4\nrestart:\n  autorestart: true\n"
                   "  startretries: 3\n")
    log_path = tmp_path / "sup.log"
    wave = _waves()["wave0"]
    with spawn_lock(tmp_path), open(log_path, "w") as log:
        sup = subprocess.Popen(
            [sys.executable, "-m",
             "asr2pass_tpu_torch.server.run_all_servers", "--config",
             str(cfg)],
            cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT)
        try:
            _wait_listening(sup, port, log_path)
            first = asyncio.run(_request(port, "offline", wave))
            pid = int(open(log_path).read().split("(pid ")[1].split(")")[0])
            os.kill(pid, signal.SIGKILL)
            deadline = time.time() + SERVER_TIMEOUT_S
            while "restart 1/3" not in open(log_path).read():
                assert time.time() < deadline
                time.sleep(0.2)
            _wait_listening(sup, port, log_path)
            again = asyncio.run(_request(port, "offline", wave))
        finally:
            sup.send_signal(signal.SIGTERM)
            rc = sup.wait(timeout=60)
    text = open(log_path).read()
    assert rc == 0, text[-3000:]
    assert first == again and first[0]["text"]
    assert text.count("restart ") == 1
    pids = [int(p.split(")")[0]) for p in text.split("(pid ")[1:]]
    assert len(pids) == 2
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(p, 0)


def test_fanout_lock_orders_many_threads(dirs, tmp_path):
    """More rank-0 threads than cores uploading at once through the
    fan-out of a world-size-1 gloo group, the interpreter switching
    threads often: every upload gets its serial result, and every call
    went out once, each under the lock."""
    import threading

    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from torch_parallel_workers import _server_models

    n = (os.cpu_count() or 4) + 1
    waves = [speechy(0.8, 90 + k) for k in range(n)]
    assert init_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                            device="cpu", timeout_s=120)
    interval = sys.getswitchinterval()
    try:
        models = _server_models({"argv": dirs["argv"]}, "asr",
                                ["--tp-devices", "1"])
        recs = [models.create_offline_recognizer(vad_tail_sil=800 + k)
                for k in range(n)]
        serial = [upload_result(r, w) for r, w in zip(recs, waves)]
        calls = models.fanout.calls
        got = [None] * n

        def upload(k):
            got[k] = upload_result(recs[k], waves[k])

        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=upload, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert got == serial and all(text for text, _ in serial)
        assert models.fanout.calls - calls == n
        assert len(models.fanout.lock_wait_s) == models.fanout.calls
        models.fanout.stop()
    finally:
        sys.setswitchinterval(interval)
        dist.destroy_process_group()


def test_sp_server_whole_model_calls_stay_on_rank0(dirs, tmp_path):
    """On an --sp-devices server only the recognizers that hold the sp
    mesh reach the fan-out: a 2pass session's Paraformer, a SenseVoice
    session and the SP recognizer's warm-up forward run on rank 0 alone
    (fanout.calls stays 0); an upload past the threshold goes out once."""
    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from torch_parallel_workers import _server_models

    waves = _waves()
    assert init_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                            device="cpu", timeout_s=120)
    try:
        models = _server_models(
            {"argv": dirs["argv"]}, "svs",
            ["--sp-devices", "1", "--sp-threshold", str(SP_THRESHOLD)])
        fan = models.fanout
        asr = models.create_session(mode="2pass")
        svs = models.create_session(mode="2pass", use_svs=True)
        assert asr.offline_asr.fanout is None
        assert svs.offline_asr.fanout is None
        assert _nonempty(session_results(asr, waves["wave0"]))
        session_results(svs, waves["wave1"])
        rec = models.create_offline_recognizer(vad_max_len=60000)
        assert rec.asr.fanout is fan
        dim = rec.asr.cfg.frontend.lfr_dim
        rec.asr.forward_feats(torch.zeros(1, 64, dim), [64])
        assert fan.calls == 0
        assert upload_result(rec, waves["wave2"])[0]
        assert fan.calls == 0
        assert upload_result(rec, waves["long"])[0]
        assert fan.calls == 1
        fan.stop()
    finally:
        dist.destroy_process_group()


def test_stats_do_not_wait_on_a_pass2_call(dirs, tmp_path):
    """The server's "stats" report (asked on the event loop) reads the
    fan-out's counters without the call lock: it returns while an upload
    holds the fan-out, and the upload then finishes as usual."""
    import threading

    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from asr2pass_tpu_torch.server.ws_server import AsrWsServer
    from torch_parallel_workers import _server_models

    wave = _waves()["wave0"]
    assert init_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                            device="cpu", timeout_s=120)
    try:
        models = _server_models({"argv": dirs["argv"]}, "asr",
                                ["--tp-devices", "1"])
        server = AsrWsServer(models, "127.0.0.1", 0)
        rec = models.create_offline_recognizer()
        serial = upload_result(rec, wave)
        inside, release = threading.Event(), threading.Event()
        inner = rec.asr._dispatch

        def held(*a, **kw):             # a long call: the lock is held
            inside.set()
            assert release.wait(60)
            return inner(*a, **kw)

        rec.asr._dispatch = held
        got = {}
        upload = threading.Thread(
            target=lambda: got.update(r=upload_result(rec, wave)))
        upload.start()
        try:
            assert inside.wait(60) and models.fanout.lock.locked()
            report = {}
            ask = threading.Thread(
                target=lambda: report.update(server.stats()))
            ask.start()
            ask.join(timeout=5)
            assert not ask.is_alive(), "stats waited on the pass-2 call"
            assert report["fanout"]["calls"] == models.fanout.calls >= 2
            assert models.fanout.lock.locked()
        finally:
            release.set()
            upload.join(timeout=60)
        assert got["r"] == serial
        models.fanout.stop()
        server.executor.shutdown()
    finally:
        dist.destroy_process_group()
