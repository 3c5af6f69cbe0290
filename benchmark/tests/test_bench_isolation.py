"""What the benchmark loads: no file of it imports jax or the JAX package,
the reference imports nothing of the program, a rehearsal run loads
neither, and a measurement run without a card exits with no result."""
import ast
import os
import subprocess
import sys

from benchmark.lib import harness

BANNED = {"jax", "jaxlib", "flax", "asr2pass_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        assert not imported_tops(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        tops = imported_tops(path)
        assert "asr2pass_tpu_torch" not in tops and not tops & BANNED, path


def test_a_rehearsal_loads_no_jax():
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(harness.ROOT)!r}, "
        f"{str(harness.BENCH / 'tests')!r}]\n"
        "import bench_tiny\n"
        "from benchmark.lib import harness\n"
        "name = bench_tiny.cells()[0]\n"
        "out = harness.run(bench_tiny.cell(name), 5, 0.5, False,"
        " torch.device('cpu'))\n"
        "print(json.dumps(harness.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_measurement_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    name = harness.load_json(harness.ROOT / "BENCHMARK.json")[
        "workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=harness.ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
