"""The port's offline tools against the JAX package's on the CPU:
compute_wer (the cases of tests/test_tools.py:17-46, the native
alignment against its Python DP and JAX's align), textnorm, and the
transcribe and eval_cer CLIs on one tiny model dir and scp (in-process,
and eval_cer --server against the port's server on a free port)."""
import argparse
import asyncio
import json
import os
import threading
import wave as wavmod

import jax
import numpy as np
import pytest

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu.tools import compute_wer as jwer
from asr2pass_tpu.tools import eval_cer as jeval
from asr2pass_tpu.tools import textnorm as jnorm
from asr2pass_tpu.tools import transcribe as jtranscribe
from asr2pass_tpu_torch.frontend.audio import load_audio_file
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.server.run_server import build_models, parser
from asr2pass_tpu_torch.server.ws_server import AsrWsServer
from asr2pass_tpu_torch.tools import compute_wer as twer
from asr2pass_tpu_torch.tools import eval_cer as teval
from asr2pass_tpu_torch.tools import textnorm as tnorm
from asr2pass_tpu_torch.tools import transcribe as ttranscribe
from asr2pass_tpu_torch.tools.transcribe import build_recognizer
from torch_parity import bursty, jax_params, tiny_cfgs


# -- compute_wer --------------------------------------------------------------

def test_tokenize_mixed():
    assert twer.tokenize("你好 hello WORLD") == ["你", "好", "hello", "world"]
    assert twer.tokenize("<noise> 你好") == ["你", "好"]
    assert twer.tokenize("it's a-b") == ["it's", "a-b"]
    assert twer.tokenize("你好，世界。") == ["你", "好", "世", "界"]


def test_score_pair_counts():
    tnb.reset_call_counts()
    _, line = twer.score_pair("你好世界", "你坏世界了")
    assert line["sub"] == 1      # 好->坏
    assert line["ins"] == 1      # 了
    assert line["del"] == 0
    assert abs(line["wer"] - 2 / 4) < 1e-9
    assert tnb.call_counts()["edit_align"] == 1     # the native call


def test_score_accumulates():
    stats = twer.WerStats()
    stats, _ = twer.score_pair("你好", "你好", stats)
    stats, _ = twer.score_pair("天气", "天七", stats)
    assert stats.sentences == 2
    assert stats.ref_len == 4
    assert stats.errors == 1
    assert abs(stats.wer - 0.25) < 1e-9


@pytest.mark.parametrize("align", [twer.align, twer.align_plain],
                         ids=["native", "plain"])
def test_align_ops(align):
    ops, dist = align(["a", "b", "c"], ["a", "c"])
    assert dist == 1
    assert ops.count(2) == 1


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        a = list(rng.choice(list("abcde"), rng.integers(0, 25)))
        b = list(rng.choice(list("abcde"), rng.integers(0, 25)))
        yield a, b


def test_native_align_equals_python_dp_and_jax():
    """300 seeded pairs (empty ones included): the native ops and distance
    equal the Python DP's and JAX's align's."""
    for a, b in _pairs(300, 0):
        got = twer.align(a, b)
        assert got == twer.align_plain(a, b) == jwer.align(a, b), (a, b)


def test_native_align_raises_instead_of_falling_back(monkeypatch):
    """A failing library call raises; nothing falls back to the DP."""
    def broken():
        raise RuntimeError("no library")

    monkeypatch.setattr(tnb, "library", broken)
    with pytest.raises(RuntimeError, match="no library"):
        twer.score_pair("你好", "你")


def test_compute_wer_cli_matches_jax(tmp_path, capsys):
    ref = tmp_path / "ref.txt"
    hyp = tmp_path / "hyp.txt"
    ref.write_text("u1 你好世界\nu2 hello big world\nu3 天气\n",
                   encoding="utf-8")
    hyp.write_text("u1 你坏世界了\nu2 hello world\n", encoding="utf-8")
    assert jwer.main([str(ref), str(hyp)]) == 0
    want = capsys.readouterr().out
    assert twer.main([str(ref), str(hyp)]) == 0
    assert capsys.readouterr().out == want


# -- textnorm -------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "今天是2025年", "增长了12.5%", "电话13800138000", "温度-3℃", "价格$100",
    "0571", "3+4=7", "30005人", "100000000", "10个", "零点5.05",
    "一共￥1001.10"])
def test_textnorm_matches_jax(text):
    assert tnorm.normalize_zh(text) == jnorm.normalize_zh(text)


def test_int_to_zh_matches_jax():
    for n in list(range(-20, 2100)) + [10 ** k + 7 for k in range(3, 12)]:
        assert tnorm.int_to_zh(n) == jnorm.int_to_zh(n), n


# -- transcribe and eval_cer on one model dir and scp -----------------------

def _write_wav(path, samples, fs):
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wavmod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A JAX-saved paraformer_tiny dir (timestamp head), a VAD dir of
    random FSMN weights (VadConfig(), no yaml), four WAVs of speech-like
    bursts (one at 8 kHz), their scp and seeded reference text."""
    tmp = tmp_path_factory.mktemp("tools")
    jcfg, _ = tiny_cfgs(timestamp=True)
    vocab = make_test_vocab(jcfg.vocab_size)
    model_dir, vad_dir = str(tmp / "model"), str(tmp / "vad")
    jzoo.save_offline_bundle(model_dir, jax_params(jcfg, 0), jcfg,
                             vocab.tokens)
    os.makedirs(vad_dir)
    jzoo.save_params(os.path.join(vad_dir, "weights.npz"), jax.tree.map(
        np.asarray, jvad.init(jax.random.PRNGKey(1), jconfig.VadConfig())))
    scp, ref = [], []
    rng = np.random.default_rng(3)
    for i, fs in enumerate((16000, 16000, 8000, 16000)):
        wave = bursty([(0.4, False), (1.2 + 0.3 * i, True), (0.5, False)],
                      seed=40 + i)
        if fs != 16000:
            wave = wave[::2]
        path = tmp / f"u{i}.wav"
        _write_wav(path, wave, fs)
        scp.append(f"u{i} {path}")
        ref.append(f"u{i} " + "".join(vocab.tokens[k] for k in
                                      rng.integers(4, len(vocab.tokens), 6)))
    (tmp / "wav.scp").write_text("\n".join(scp) + "\n", encoding="utf-8")
    (tmp / "text").write_text("\n".join(ref) + "\n", encoding="utf-8")
    return dict(tmp=tmp, model=model_dir, vad=vad_dir,
                scp=str(tmp / "wav.scp"), ref=str(tmp / "text"))


def _texts(out_dir):
    lines = (out_dir / "text").read_text(encoding="utf-8").splitlines()
    return dict(line.split("\t", 1) for line in lines)


@pytest.mark.parametrize("vad", [False, True])
def test_transcribe_cli_matches_jax(dirs, vad):
    """The same texts (the text file and each .asr.txt) from both CLIs on
    the same dir and scp, with and without the VAD dir."""
    args = ["--scp", dirs["scp"], "--model-dir", dirs["model"]]
    if vad:
        args += ["--vad-dir", dirs["vad"]]
    jout, tout = dirs["tmp"] / f"jax{vad}", dirs["tmp"] / f"port{vad}"
    assert jtranscribe.main(args + ["--output-dir", str(jout)]) == 0
    assert ttranscribe.main(args + ["--output-dir", str(tout),
                                    "--device", "cpu"]) == 0
    ref = _texts(jout)
    assert len(ref) == 4 and any(ref.values())
    assert _texts(tout) == ref
    for name in ref:
        assert ((tout / f"{name}.asr.txt").read_text(encoding="utf-8")
                == (jout / f"{name}.asr.txt").read_text(encoding="utf-8"))


def _report(tmp, tag):
    rep = json.loads((tmp / f"{tag}.json").read_text(encoding="utf-8"))
    rep.pop("wall_s")
    hyps = (tmp / f"{tag}.hyp").read_text(encoding="utf-8")
    return rep, hyps


def test_eval_cer_in_process_matches_jax(dirs):
    """The same hypotheses and report (CER, counts, per-utt lines) from
    both CLIs in-process, with the VAD dir."""
    tmp = dirs["tmp"]
    common = ["--scp", dirs["scp"], "--ref", dirs["ref"], "--model-dir",
              dirs["model"], "--vad-dir", dirs["vad"]]
    for tag, fn, extra in (("jax_ip", jeval.main, []),
                           ("port_ip", teval.main, ["--device", "cpu"])):
        assert fn(common + extra + ["--out", str(tmp / f"{tag}.json"),
                                    "--hyp-out", str(tmp / f"{tag}.hyp")]) \
            == 0
    ref_rep, ref_hyps = _report(tmp, "jax_ip")
    assert ref_rep["sentences"] == 4 and ref_rep["ref_len"] == 24
    assert _report(tmp, "port_ip") == (ref_rep, ref_hyps)


@pytest.fixture(scope="module")
def server(dirs):
    """The port's server, launched from the dirs by build_models, on a
    free port in a thread of its own."""
    models = build_models(parser().parse_args(
        ["--model-dir", dirs["model"], "--vad-dir", dirs["vad"],
         "--device", "cpu"]))
    srv_obj = AsrWsServer(models, host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        srv = loop.run_until_complete(srv_obj.serve())
        holder["port"] = srv.sockets[0].getsockname()[1]
        started.set()
        try:
            loop.run_forever()
        finally:
            srv.close()
            loop.run_until_complete(srv.wait_closed())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert started.wait(60)
    yield f"ws://127.0.0.1:{holder['port']}", models
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)
    assert not th.is_alive()
    srv_obj.executor.shutdown(wait=False)


def test_eval_cer_server_matches_in_process(dirs, server):
    """--server against the port's server gives the in-process run's
    hypotheses and CER: the port's client sends each WAV's own 16-bit
    samples at its own rate, so the server decodes what the in-process
    run reads."""
    url, _ = server
    tmp = dirs["tmp"]
    assert teval.main(["--scp", dirs["scp"], "--ref", dirs["ref"],
                       "--server", url, "--out", str(tmp / "port_srv.json"),
                       "--hyp-out", str(tmp / "port_srv.hyp")]) == 0
    if not (tmp / "port_ip2.json").exists():
        assert teval.main(["--scp", dirs["scp"], "--ref", dirs["ref"],
                           "--model-dir", dirs["model"], "--vad-dir",
                           dirs["vad"], "--device", "cpu",
                           "--out", str(tmp / "port_ip2.json"),
                           "--hyp-out", str(tmp / "port_ip2.hyp")]) == 0
    got, got_hyps = _report(tmp, "port_srv")
    ref, ref_hyps = _report(tmp, "port_ip2")
    assert got_hyps == ref_hyps
    assert {k: v for k, v in got.items() if k != "audio_s"} == {
        k: v for k, v in ref.items() if k != "audio_s"}


def test_jax_eval_cer_against_the_port_server(dirs, server):
    """JAX's eval_cer --server against the port's server: its client
    sends each file resampled to 16 kHz and requantized as
    trunc(x * 32767); the port's recognizer on exactly those samples
    gives the hypotheses it gets back."""
    url, models = server
    tmp = dirs["tmp"]
    assert jeval.main(["--scp", dirs["scp"], "--ref", dirs["ref"],
                       "--server", url, "--hyp-out",
                       str(tmp / "jax_srv.hyp")]) == 0
    got = dict(line.split("\t", 1) for line in (tmp / "jax_srv.hyp")
               .read_text(encoding="utf-8").splitlines())
    rec = build_recognizer(argparse.Namespace(
        model_dir=dirs["model"], svs_dir="", vad_dir=dirs["vad"],
        punc_dir="", itn=False, device="cpu"))
    for line in open(dirs["scp"], encoding="utf-8"):
        name, path = line.split()
        wave = load_audio_file(path, 16000)
        sent = (np.clip(wave, -1, 1) * 32767).astype("<i2")
        res = rec.transcribe(sent.astype(np.float32) / 32768.0,
                             use_itn=False)
        assert got[name] == res.text, name
    assert any(got.values())
