"""Shared pieces of the benchmark's tests: tiny copies of the cells that
run on the CPU (``pytest portbench/tests`` from the root of the
repository)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell's configuration at a size a test run holds
TINY = {
    "session16x60.spectral": {"channels": 4, "seconds": 0.25},
    "fb64x10.banks": {"channels": 12, "seconds": 0.2},
}


def tiny_cell(name: str):
    from portbench import harness

    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), name)
    cell.config.update(TINY[name])
    return cell


def run_cpu(cell, seed: int = 2**31 + 17, seconds: float = 0.2, program_factory=None) -> dict:
    from portbench import harness

    return harness.run(cell, seed, seconds, False, "cpu", time.perf_counter(),
                       program_factory=program_factory)


@pytest.fixture
def card():
    """Skips unless a CUDA device is there (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
