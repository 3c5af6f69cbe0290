"""The port stands alone: asr2pass_tpu_torch and chip_smoke.py import
neither jax nor any module of the JAX package and name no path under it
(so they cannot read its sources or load its native build), its entry
points run on the card unless the caller asks for the CPU, and
chip_smoke.py refuses to run (printing no result) without a card or
outside a checkout."""
import ast
import io
import os
import re
import subprocess
import sys
import tokenize
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "asr2pass_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import asr2pass_tpu_torch
for m in pkgutil.walk_packages(asr2pass_tpu_torch.__path__,
                               "asr2pass_tpu_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "asr2pass_tpu" or m.startswith("asr2pass_tpu.")]
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("asr2pass_tpu_torch")]))
"""


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "asr2pass_tpu")


def test_port_imports_leave_jax_out():
    """In a fresh interpreter (tests/conftest.py imports jax here)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_new_tools_run_without_jax(tmp_path):
    """The converter, the ONNX executor, fetch_model (with urllib),
    quality (its lazy imports: the executor and, for 8 kHz audio, the
    resampler) and segment_filter (compute_wer) imported and used in a
    fresh interpreter: jax and the JAX package stay out."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO / "tests")!r})
import numpy as np
from torch_onnx_fixtures import dnsmos_graphs
from asr2pass_tpu_torch.tools import (convert_funasr, fetch_model,
                                      onnx_reader, quality, segment_filter)
import urllib.request
d = dnsmos_graphs({str(tmp_path)!r})
sc = quality.DnsmosScorer(d, device="cpu")
print(sc.score(np.zeros(8000 * 10, np.float32) + 0.01, 8000))
print(segment_filter.filter_segments.__name__, fetch_model.PRESETS.keys(),
      convert_funasr.CONVERTERS.keys(), onnx_reader.OnnxExecutor.__name__)
from asr2pass_tpu_torch.tools.compute_wer import score_pair
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "asr2pass_tpu")]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "p808_mos" in res.stdout


@pytest.mark.parametrize("name,forbidden", [
    ("jax", True), ("jax.numpy", True), ("asr2pass_tpu", True),
    ("asr2pass_tpu.ops.attention", True), ("asr2pass_tpu_torch", False),
    ("asr2pass_tpu_torch.ops", False), ("jaxtyping", False)])
def test_forbidden_prefix_rule(name, forbidden):
    assert _forbidden(name) is forbidden


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "chip_repro_10c.py",
                                         REPO / "chip_repro_profiler.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    """A static scan, which also sees imports inside functions."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


# a path under the JAX package: "asr2pass_tpu/..." (not
# "asr2pass_tpu_torch/"), or a string that is the bare directory name (a
# path component to join)
_JAX_PATH = re.compile(r"(?<![\w.])asr2pass_tpu/")
# the one form allowed: a whole string that cites a line of a JAX file,
# as chip_smoke.py's kernel line names the TPU kernel each CUDA kernel
# replaces ("replaces": "file:line"); it cannot be opened as a path
_CITATION = re.compile(r"^asr2pass_tpu/[\w/]+\.py:\d+$")


def _names_jax_path(text: str) -> bool:
    return text.strip() == "asr2pass_tpu" or (
        not _CITATION.match(text) and _JAX_PATH.search(text) is not None)


@pytest.mark.parametrize("text,names", [
    ("asr2pass_tpu/native/build/libasr2native.so", True),
    ("../asr2pass_tpu/native/src", True),
    ("asr2pass_tpu", True),
    ("see asr2pass_tpu/decode/ctc.py", True),
    ("asr2pass_tpu/ops/attention.py:129", False),
    ("asr2pass_tpu/ops/attention.py:129 and asr2pass_tpu/x.py", True),
    ("asr2pass_tpu_torch/native/src", False),
    ("the JAX package's native/src/ctc_beam.cc", False),
    ("asr2pass_tpu.native", False)])
def test_jax_path_rule(text, names):
    assert _names_jax_path(text) is names


def _all_port_files():
    """Every file of the port (sources of any kind, build output left
    out), chip_smoke.py and the chip_repro_*.py scripts."""
    return sorted(p for p in PORT.rglob("*") if p.is_file()
                  and "_build" not in p.parts and "__pycache__" not in p.parts
                  and p.suffix != ".pyc") + [REPO / "chip_smoke.py",
                                             REPO / "chip_repro_10c.py",
                                             REPO / "chip_repro_profiler.py"]


def _texts(path: Path):
    """(line, text) of every string literal and comment of a Python
    file; of every line of any other file."""
    src = path.read_text()
    if path.suffix != ".py":
        yield from enumerate(src.splitlines(), 1)
        return
    for node in ast.walk(ast.parse(src, filename=str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.string


@pytest.mark.parametrize("path", _all_port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_path(path):
    """No string, comment or source line names a path under the JAX
    package: the port builds and runs from its own files only."""
    bad = [(n, t) for n, t in _texts(path) if _names_jax_path(t)]
    assert not bad, (path, bad)


def _entry_points(tmp_path):
    import argparse

    from asr2pass_tpu_torch.config import (FrontendConfig, HotwordConfig,
                                           paraformer_tiny, punc_tiny,
                                           sensevoice_tiny, vad_default)
    from asr2pass_tpu_torch.models import (ct_transformer, fsmn_vad, hotword,
                                           paraformer, sensevoice)
    from asr2pass_tpu_torch.runtime import streaming_frontend as sf
    from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.punc import Punctuator
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.runtime.vad_stream import (FsmnVadStream,
                                                       vad_segments_offline)
    from asr2pass_tpu_torch.server.engine import ServerModels
    from asr2pass_tpu_torch.server.run_server import build_models, parser
    from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
    from asr2pass_tpu_torch.text.vocab import Vocab
    from asr2pass_tpu_torch.runtime.model_zoo import save_offline_bundle
    from asr2pass_tpu_torch.tools.transcribe import build_recognizer
    from asr2pass_tpu_torch.utils import quantize_params

    cfg, vcfg, pcfg = paraformer_tiny(), vad_default(), punc_tiny()
    sd = paraformer.init(cfg, device="cpu").state_dict()
    model_dir = str(tmp_path / "model")
    save_offline_bundle(model_dir, sd, cfg, ["a"] * cfg.vocab_size)
    cli = argparse.Namespace(model_dir=model_dir, svs_dir="", vad_dir="",
                             punc_dir="", itn=False)
    vsd = fsmn_vad.init(vcfg, device="cpu").state_dict()
    psd = ct_transformer.init(pcfg, device="cpu").state_dict()
    hcfg = HotwordConfig(vocab_size=64, embed_dim=16, hidden_dim=16)
    hsd = hotword.init(hcfg, device="cpu").state_dict()
    scfg = sensevoice_tiny()
    ssd = sensevoice.init(scfg, device="cpu", tp_blocks=1).state_dict()
    vocab = Vocab(["a"] * cfg.vocab_size)
    wave = np.zeros(4000, np.float32)
    return {
        "init": lambda **kw: paraformer.init(cfg, **kw),
        "from_state_dict": lambda **kw: paraformer.from_state_dict(
            sd, cfg, **kw),
        "ParaformerOffline": lambda **kw: ParaformerOffline(
            sd, cfg, vocab, **kw),
        "offline_frontend": lambda **kw: sf.offline_frontend(
            wave, FrontendConfig(), **kw),
        "offline_frontend_device": lambda **kw: sf.offline_frontend_device(
            [wave], [23], 64, FrontendConfig(), **kw),
        "StreamingFrontend": lambda **kw: sf.StreamingFrontend(
            FrontendConfig(), **kw),
        "ParaformerOnlineStream": lambda **kw: ParaformerOnlineStream(
            sd, cfg, vocab, **kw),
        "fsmn_vad.init": lambda **kw: fsmn_vad.init(vcfg, **kw),
        "fsmn_vad.from_state_dict": lambda **kw: fsmn_vad.from_state_dict(
            vsd, vcfg, **kw),
        "fsmn_vad.init_caches": lambda **kw: fsmn_vad.init_caches(
            vcfg, 1, **kw),
        "FsmnVadStream": lambda **kw: FsmnVadStream(vsd, vcfg, **kw),
        "vad_segments_offline": lambda **kw: vad_segments_offline(
            vsd, vcfg, wave, **kw),
        "ct_transformer.init": lambda **kw: ct_transformer.init(pcfg, **kw),
        "ct_transformer.from_state_dict":
            lambda **kw: ct_transformer.from_state_dict(psd, pcfg, **kw),
        "Punctuator": lambda **kw: Punctuator(
            psd, pcfg, PuncTokenizer(["a"] * pcfg.vocab_size), **kw),
        "hotword.init": lambda **kw: hotword.init(hcfg, **kw),
        "hotword.from_state_dict": lambda **kw: hotword.from_state_dict(
            hsd, **kw),
        "sensevoice.init": lambda **kw: sensevoice.init(scfg, **kw),
        "sensevoice.from_state_dict":
            lambda **kw: sensevoice.from_state_dict(ssd, scfg, **kw),
        "SenseVoiceOffline": lambda **kw: SenseVoiceOffline(
            ssd, scfg, vocab, **kw),
        # the server's registry; StreamEngine and AsrWsServer run on its
        # device
        "ServerModels": lambda **kw: ServerModels(
            asr_params=sd, asr_cfg=cfg, vocab=vocab, vad_params=vsd,
            vad_cfg=vcfg, hotword_params=hsd, svs_params=ssd, svs_cfg=scfg,
            **kw),
        # the launcher: --device defaults to cuda
        "build_models": lambda **kw: build_models(parser().parse_args(
            ["--demo"] + [f"--device={v}" for v in kw.values()])),
        # an int8 model, and the offline tools' build_recognizer (the
        # CLIs' --device defaults to cuda)
        "ParaformerOffline(int8)": lambda **kw: ParaformerOffline(
            quantize_params(sd), cfg, vocab, **kw),
        "build_recognizer": lambda **kw: build_recognizer(
            argparse.Namespace(**vars(cli), **kw)),
    }


@pytest.mark.parametrize("name", [
    "init", "from_state_dict", "ParaformerOffline", "offline_frontend",
    "offline_frontend_device", "StreamingFrontend",
    "ParaformerOnlineStream", "fsmn_vad.init", "fsmn_vad.from_state_dict",
    "fsmn_vad.init_caches", "FsmnVadStream", "vad_segments_offline",
    "ct_transformer.init", "ct_transformer.from_state_dict", "Punctuator",
    "hotword.init", "hotword.from_state_dict", "sensevoice.init",
    "sensevoice.from_state_dict", "SenseVoiceOffline",
    "ServerModels", "build_models", "ParaformerOffline(int8)",
    "build_recognizer"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """Without device="cpu" an entry point asks for CUDA, and on a machine
    without it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    fn = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    fn(device="cpu")


@pytest.mark.parametrize("module", ["transcribe", "eval_cer",
                                    "convert_funasr", "fetch_model",
                                    "quality", "segment_filter"])
def test_cli_device_defaults_to_the_card(module):
    """The offline CLIs take --device, default cuda, as build_models'
    launcher does."""
    import importlib

    src = (PORT / "tools" / f"{module}.py").read_text()
    importlib.import_module(f"asr2pass_tpu_torch.tools.{module}")
    assert "add_device_arg(p)" in src
    from asr2pass_tpu_torch.tools.transcribe import add_device_arg
    import argparse
    p = argparse.ArgumentParser()
    add_device_arg(p)
    assert p.parse_args([]).device == "cuda"


def test_chip_smoke_refuses_without_card(tmp_path):
    """No card: non-zero exit and no result line. Outside a checkout (the
    script alone in a directory): the same."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
