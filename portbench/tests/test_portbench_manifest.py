"""A cell, a configuration, a traffic mix and a metric added as new files
and new entries only are found by name: the harness needs no edit."""

import json
import shutil
import subprocess
import sys

from .conftest import ROOT

SCRIPT = """
import json, sys, time
sys.path.insert(0, {copy!r})
sys.path.append({root!r})
from portbench import harness
assert harness.ROOT == __import__("pathlib").Path({copy!r})
m = harness.load_json(harness.ROOT / "BENCHMARK.json")
cell = harness.load_cell(m, "tiny.spectral_once")
r = harness.run(cell, 2**31 + 3, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(r))
"""


def test_new_cell_from_new_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy / "portbench"
    cfg = json.loads((bench / "configs/session16x60.json").read_text())
    cfg.update(name="tiny", channels=2, seconds=0.1)
    (bench / "configs/tiny.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "traffic/spectral.json", bench / "traffic/spectral_once.json")
    (bench / "limits/tiny.spectral_once.json").write_text(
        (bench / "limits/session16x60.spectral.json").read_text())
    (bench / "metrics/calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    manifest["configs"].append({"name": "tiny", "source": "https://example.org",
                                "file": "portbench/configs/tiny.json", "reduced": [],
                                "why": "test"})
    manifest["workloads"].append({"name": "tiny.spectral_once", "config": "tiny",
                                  "traffic": "spectral_once", "chips": 1, "why": "test"})
    manifest["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["tiny.spectral_once"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    r = subprocess.run([sys.executable, "-c", SCRIPT.format(copy=str(copy), root=str(ROOT))],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "call_ms_p95", "setup_s", "calls_per_s"}
    assert res["metrics"]["audio_s_per_s"]["value"] > 0
