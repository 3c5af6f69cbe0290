"""The control of a cell's check: the plain reference computed in TF32 (the
next precision below the configurations' float32) put in the program's
place, read by the same comparison as a run. Its readings set the upper
end of each limit (benchmark/configs/<config>.json "limits").

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it takes the longest file of the pool and the files a run
of that seed serves first, as many as a run's check compares, and prints
the readings beside the limits. It needs the card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    from benchmark.families import common

    family = importlib.import_module(
        f"benchmark.families.{cell.config['family']}").Family(cell.config)
    traffic = importlib.import_module(
        f"benchmark.traffic.{cell.workload['traffic']}")
    params = cell.workload["params"]
    files = traffic.pool(params, seed, device)
    longest = max(range(len(files)), key=lambda i: len(files[i]))
    first = next(traffic.passes(len(files), seed))
    pick = [longest] + [i for i in first if i != longest]
    pick = pick[: params["sample_files"]]
    read = common.Readings()
    family.control([files[i] for i in pick], seed, device, read)
    return read.values


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import chip, harness

    cell = harness.Cell(args.workload)
    chip.require_cards(1)
    import torch

    limits = cell.config["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        values = readings(cell, seed, torch.device("cuda", 0))
        fails = sorted(k for k, v in values.items()
                       if k in limits and v > limits[k])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "readings": values, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
