"""The benchmark's CPU tests: the checkout's root on the import path, and
the marker of the tests that need a card (they skip without one)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips (with a reason) without one")
