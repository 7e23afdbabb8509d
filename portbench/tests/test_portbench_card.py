"""On the card: one short run of each cell, traced, prints a correct
result line with every per-layer metric of the cell."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

CELLS = {"session16x60.spectral": "framing_roofline",
         "fb64x10.banks": "iir_bank_roofline"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_on_the_card(card, name):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                        "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert {"host_issue_ms", "torch_ops_ms", "device_idle_pct", CELLS[name]} == set(res["metrics"])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"][CELLS[name]]["value"] <= 105
