"""Benchmark of asr2pass_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One process: the cell's models on the card from the seed, its traffic,
a warm-up over every shape the traffic uses (set-up), a window of
`--seconds`, the check of what the window served against the plain
reference, and the result as the last line of standard output. With
`--trace 1` the window is traced and the result carries the per-layer
metrics. A run needs the CUDA devices its cell asks for; without them it
exits with code 2 and prints no result. See benchmark/README.md.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    from benchmark.lib import chip, harness

    cell = harness.Cell(args.workload)
    chip.require_cards(cell.entry["chips"])
    import torch

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
