"""The seeded weights: their keys and shapes are the program's state
dicts at the configurations' own widths, and one seed gives one set."""
import pytest
import torch

from benchmark.families import common, paraformer, sensevoice
from benchmark.lib import harness, weights
from benchmark.reference import config as rc

CONFIGS = [c["name"] for c in
           harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]]


def shapes(spec):
    return {k: tuple(shape) for k, (shape, _) in spec.items()}


def program_shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_specs_are_the_program_layouts(name):
    from asr2pass_tpu_torch import config as pc
    from asr2pass_tpu_torch.models import (ct_transformer, fsmn_vad,
                                           paraformer as p_par,
                                           sensevoice as p_svs)

    node = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    vcfg = common.vad_cfg(rc, node["vad"])
    assert shapes(weights.fsmn_vad(vcfg)) == program_shapes(
        fsmn_vad.FsmnVad(common.vad_cfg(pc, node["vad"]), device="meta"))
    if node["family"] == "paraformer":
        cfg = paraformer.asr_cfg(rc, node["asr"])
        prog = p_par.Paraformer(paraformer.asr_cfg(pc, node["asr"]),
                                device="meta")
        assert shapes(weights.paraformer(cfg)) == program_shapes(prog)
        pcfg = common.punc_cfg(rc, node["punc"])
        assert shapes(weights.ct_transformer(
            pcfg, common.punc_encoder(rc, pcfg))) == program_shapes(
                ct_transformer.CtTransformer(common.punc_cfg(pc, node["punc"]),
                                             device="meta"))
    else:
        cfg = sensevoice.asr_cfg(rc, node["asr"])
        tp = node["asr"]["tp_blocks"]
        prog = p_svs.SenseVoice(sensevoice.asr_cfg(pc, node["asr"]),
                                tp_blocks=tp, device="meta")
        assert shapes(weights.sensevoice(cfg, tp)) == program_shapes(prog)


def test_one_seed_one_set():
    spec = weights.fsmn_vad(rc.VadConfig())
    a = weights.make(spec, 2147483649, "vad", "cpu")
    b = weights.make(spec, 2147483649, "vad", "cpu")
    c = weights.make(spec, 2147483650, "vad", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["in1.w"], c["in1.w"])
