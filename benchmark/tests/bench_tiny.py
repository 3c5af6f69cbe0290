"""Small versions of the cells for CPU rehearsals: the published widths
cut to a few channels and blocks, the traffic to two short files."""
import copy

from benchmark.lib import harness


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_json(
        harness.BENCH / "configs" / f"{name}.json"))
    a = cfg["asr"]
    a["encoder"].update(output_size=64, num_blocks=2, attention_heads=2,
                        linear_units=128)
    a["vocab_size"] = 64
    if "decoder" in a:
        a["decoder"].update(num_blocks=2, attention_heads=2, linear_units=128)
        a["predictor"]["idim"] = 64
    if "tp_blocks" in a:
        a["tp_blocks"] = 2
    if "punc" in cfg:
        cfg["punc"].update(vocab_size=128, embed_dim=32, att_dim=32,
                           num_blocks=2, attention_heads=2, linear_units=64)
    return cfg


def workload(name: str) -> dict:
    wl = copy.deepcopy(harness.load_json(
        harness.BENCH / "workloads" / f"{name}.json"))
    wl["params"].update(file_seconds=[6, 9], burst_s=[1.0, 2.5],
                        pause_s=[0.9, 1.5], sample_files=2)
    return wl


def cell(name: str) -> harness.Cell:
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    wl = workload(name)
    return harness.Cell(name, manifest=manifest, workload=wl,
                        config=config(wl["config"]))


def cells() -> list:
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return [w["name"] for w in manifest["workloads"]]
