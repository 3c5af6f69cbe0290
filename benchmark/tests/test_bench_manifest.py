"""BENCHMARK.json against the rules of its format (names, units, keys,
sizes, the budget of a check), and every file it names present."""
import json
import re

from benchmark.lib import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert len(M["command"]) <= 32
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]]
             + [w["name"] for w in M["workloads"]]
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in M[group]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_only_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.ROOT / c["file"]).is_file()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        wl = harness.load_json(harness.BENCH / "workloads"
                               / f"{w['name']}.json")
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.py").is_file()
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_config_is_used_and_every_metric_has_a_reader():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_each_cell_reports_what_it_needs():
    cells = [w["name"] for w in M["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in M["end_to_end"]}
    assert set(e2e["setup_s"]) == set(cells)
    for cell in cells:
        assert sum(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in M["per_layer"])
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert all("\n" not in x and 1 <= len(x) <= 200 for x in layers)


def test_budget_of_a_full_check_fits():
    runs = 2 + 14 * 24
    total = runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
