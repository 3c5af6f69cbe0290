"""The port's FunASR converter and model provisioning
(asr2pass_tpu_torch/tools/convert_funasr.py, fetch_model.py) against the
JAX package's, on the CPU.

The sources are tests/torch_parity.funasr_source_dirs' FunASR-layout
dirs (model.pt, model.onnx exported by torch, config files), the
fixtures of tests/test_onnx_verify.py. For every kind the port's
weights.npz must hold the JAX converter's keys with bit-equal arrays
(the hotword subtree included) and the copied config files must be
equal; --verify on the CPU must pass on each fixture and raise on wrong
weights, as the JAX package's tests hold its own; the converted dirs
load and decode through the port's loaders and build_models.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest

from asr2pass_tpu.tools import convert_funasr as jconv
from asr2pass_tpu.tools import onnx_reader as jreader
from asr2pass_tpu_torch.tools import convert_funasr as tconv
from asr2pass_tpu_torch.tools import fetch_model as tfetch
from torch_parity import funasr_source_dirs

KIND = {"asr": "asr", "asr_ts": "asr", "vad": "vad", "punc": "punc",
        "punc_online": "punc_online", "online": "online",
        "sensevoice": "sensevoice"}
CONFIG_FILES = ("config.yaml", "am.mvn", "tokens.json", "seg_dict")


@pytest.fixture(scope="module")
def src_dirs(tmp_path_factory):
    return funasr_source_dirs(tmp_path_factory.mktemp("funasr"))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", sorted(KIND))
def test_weights_npz_bit_equal_to_jax(src_dirs, kind, tmp_path):
    src, _ = src_dirs[kind]
    argv = ["--kind", KIND[kind]]
    assert jconv.main([str(src), str(tmp_path / "jax")] + argv) == 0
    assert tconv.main([str(src), str(tmp_path / "port")] + argv) == 0
    want = _npz(tmp_path / "jax" / "weights.npz")
    got = _npz(tmp_path / "port" / "weights.npz")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if kind == "asr":
        assert any(k.startswith("hotword_compiler/") for k in got)
    for f in CONFIG_FILES:
        j, t = tmp_path / "jax" / f, tmp_path / "port" / f
        assert j.exists() == t.exists(), f
        if j.exists():
            assert filecmp.cmp(j, t, shallow=False), f


def test_onnx_only_source_reads_as_jax_does(src_dirs, tmp_path):
    """Without model.pt the initializers of model.onnx (merged with
    decoder.onnx's) are the state dict, names stripped as the JAX CLI
    strips them; an export whose weights torch constant-folded under new
    names raises KeyError in both converters, naming a tensor the
    state dict lacks."""
    src = tmp_path / "online"
    shutil.copytree(src_dirs["online"][0], src)
    os.remove(src / "model.pt")
    want = dict(jreader.read_onnx(str(src / "model.onnx")).initializers)
    want.update(jreader.read_onnx(str(src / "decoder.onnx")).initializers)
    want = {k.removeprefix("onnx::").split("::")[0]: v
            for k, v in want.items()}
    got = tconv.read_source(str(src))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    for conv in (jconv, tconv):
        with pytest.raises(KeyError) as e:
            conv.main([str(src), str(tmp_path / "out")])
        assert e.value.args[0] not in got


VERIFY = {"asr": [], "asr_ts": ["--verify-tol", "5e-3"], "vad": [],
          "punc": [], "punc_online": ["--kind", "punc_online"],
          "online": ["--kind", "online"], "sensevoice": []}


@pytest.mark.parametrize("kind", sorted(VERIFY))
def test_verify_passes_on_the_cpu(src_dirs, kind, tmp_path):
    src, _ = src_dirs[kind]
    extra = VERIFY[kind]
    dst = tmp_path / "dst"
    assert tconv.main([str(src), str(dst), "--verify", "--device", "cpu"]
                      + extra) == 0
    assert (dst / "weights.npz").exists()


def test_verify_auto_detects_the_vad_realtime_punc_graph(src_dirs):
    """A realtime punc dir converted as kind=punc still verifies through
    the 4-input VadRealtime contract."""
    src, sd = src_dirs["punc_online"]
    params = tconv.convert_punc_state_dict(dict(sd))
    assert tconv.verify_against_onnx(str(src), params, "punc",
                                     device="cpu") < 1e-3


def _perturbed(kind, sd):
    """The converted tree with one weight changed the way a layout bug
    would change it (the JAX package's *_catches_wrong_weights cases)."""
    if kind in ("asr", "asr_ts"):
        p = tconv.convert_state_dict(dict(sd))
        p["decoder"]["out"]["w"] = p["decoder"]["out"]["w"] + 0.05
    elif kind == "online":
        p = tconv.convert_state_dict(dict(sd))
        p["encoder"]["after_norm"]["g"] = p["encoder"]["after_norm"]["g"] + 0.05
    elif kind == "vad":
        p = tconv.convert_vad_state_dict(dict(sd))
        p["blocks"][0]["taps"] = p["blocks"][0]["taps"] + 0.05
    elif kind in ("punc", "punc_online"):
        p = tconv.convert_punc_state_dict(dict(sd))
        qkv = p["encoder"]["first"]["att"]["qkv"]
        qkv["w"] = qkv["w"] + 0.03
    elif kind == "sensevoice":
        p = tconv.convert_sensevoice_state_dict(dict(sd))
        # a scale: a shift would cancel in the LayerNorm'd encoder output
        p["ctc"]["w"] = p["ctc"]["w"] * 1.05
    elif kind == "sensevoice_tables":
        p = tconv.convert_sensevoice_state_dict(dict(sd))
        p["lid_embed"] = p["lid_embed"][::-1]
    return p


@pytest.mark.parametrize("kind", sorted(KIND) + ["sensevoice_tables"])
def test_verify_catches_wrong_weights(src_dirs, kind):
    src, sd = src_dirs["sensevoice" if kind == "sensevoice_tables"
                       else kind]
    verify_kind = KIND.get(kind, "sensevoice")
    with pytest.raises(AssertionError):
        tconv.verify_against_onnx(str(src), _perturbed(kind, sd),
                                  verify_kind, device="cpu")


def test_converted_dirs_load_and_decode(src_dirs, tmp_path):
    """The migration chain a reference user runs, in the port: convert
    with --verify, then load and decode. SenseVoice through
    load_svs_bundle and SenseVoiceOffline (as the JAX package's
    test_svs_migration_chain_convert_load_decode); the Paraformer with
    the timestamp head and the hotword dir through build_models."""
    from asr2pass_tpu_torch.runtime.model_zoo import load_svs_bundle
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.server.run_server import build_models, parser

    wave = (np.random.default_rng(0).standard_normal(16000) * 0.1
            ).astype(np.float32)
    src = src_dirs["sensevoice"][0]
    assert tconv.main([str(src), str(tmp_path / "svs"), "--verify",
                       "--device", "cpu"]) == 0
    b = load_svs_bundle(str(tmp_path / "svs"))
    assert (b.cfg.encoder.output_size, b.cfg.encoder.num_blocks,
            b.cfg.vocab_size) == (32, 3, 50)
    text, _ = SenseVoiceOffline(b.params, b.cfg, b.vocab, lang="zh",
                                device="cpu").recognize(wave)
    assert isinstance(text, str)

    for kind, extra in (("asr_ts", ["--verify-tol", "5e-3"]), ("asr", [])):
        dst = tmp_path / kind
        assert tconv.main([str(src_dirs[kind][0]), str(dst), "--verify",
                           "--device", "cpu"] + extra) == 0
        models = build_models(parser().parse_args(
            ["--model-dir", str(dst), "--device", "cpu"]))
        assert (models.hotword_params is not None) == (kind == "asr")
        assert models.asr_cfg.predictor.use_timestamp == (kind == "asr_ts")
        asr = ParaformerOffline(models.asr_params, models.asr_cfg,
                                models.vocab, cmvn=models.asr_cmvn,
                                device="cpu")
        (text, stamps), = asr.recognize_batch([wave])
        assert isinstance(text, str)
        assert (len(stamps) > 0) == (kind == "asr_ts" and bool(text))


def test_cli_refuses_the_card_without_cuda(src_dirs, tmp_path):
    """--verify runs on the card unless --device cpu: without CUDA it
    raises before converting anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    src = src_dirs["vad"][0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconv.main([str(src), str(tmp_path / "x"), "--verify"])
    assert not (tmp_path / "x").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfetch.main([str(src), "--out", str(tmp_path / "y"), "--verify"])
    assert not (tmp_path / "y" / "weights.npz").exists()


# -- fetch_model ---------------------------------------------------------------

def test_fetch_model_local_dir(src_dirs, tmp_path):
    """An existing local dir skips the network, converts and verifies
    (the JAX package's test_fetch_model_local_dir), and writes the same
    weights.npz as a direct conversion."""
    src = src_dirs["asr"][0]
    assert tfetch.main([str(src), "--out", str(tmp_path / "prov"),
                        "--verify", "--device", "cpu"]) == 0
    assert tconv.main([str(src), str(tmp_path / "direct")]) == 0
    a, b = (_npz(tmp_path / d / "weights.npz") for d in ("prov", "direct"))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_fetch_model_no_network(tmp_path, monkeypatch, capsys):
    """Unreachable ModelScope: a message saying what to copy where, exit
    1, no half-provisioned dir (the JAX package's
    test_fetch_model_no_network)."""
    def boom(*a, **k):
        raise OSError("no route to host")

    monkeypatch.setattr(tfetch, "_http_json", boom)
    rc = tfetch.main(["damo/some-model", "--out", str(tmp_path / "x"),
                      "--device", "cpu"])
    assert rc == 1
    assert not (tmp_path / "x" / "weights.npz").exists()
    err = capsys.readouterr().err
    assert "cannot reach ModelScope" in err and "model.onnx" in err
    assert str(tmp_path / "x.src") in err


def test_fetch_model_presets_match_jax():
    from asr2pass_tpu.tools import fetch_model as jfetch

    assert tfetch.PRESETS == jfetch.PRESETS
    assert tfetch.WANTED == jfetch.WANTED
    assert tfetch.MODELSCOPE == jfetch.MODELSCOPE
