"""On the card: the control (the reference in TF32 in the program's
place) fails the check of each cell at the cell's own size: the files a
run of the seed compares, at the configurations' widths. Run there with

    python -m pytest benchmark/tests -q -m cuda
"""
import pytest
import torch

from benchmark import control
from benchmark.lib import harness

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.Cell(name)
    values = control.readings(cell, 2147483001, torch.device("cuda", 0))
    limits = cell.config["limits"]
    assert any(values.get(k, 0.0) > v for k, v in limits.items()), values
