"""Settings of the benchmark's own tests: ``python -m pytest portbench/tests``.

Imports no JAX.  Card-only tests carry the ``cuda`` marker and skip inside
the ``cuda_device`` fixture where there is no card; they run on the card
with ``python -m pytest portbench/tests -m cuda``.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cell of BENCHMARK.json, so that a cell added later is tested too
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def root():
    return ROOT
