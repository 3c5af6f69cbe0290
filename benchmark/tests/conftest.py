"""The benchmark's own tests (CPU; card tests skip without a card).

    python -m pytest benchmark/tests -q

The `cuda` marker names tests that need the card; each decides inside
the test whether there is one.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
