"""No JAX in a run, nothing of the program in the reference, no result
without a card."""

import ast
import json
import subprocess
import sys

from portbench import harness

from .conftest import ROOT


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    base = set(harness.forbidden_modules())
    for name in ("dsptoolbox_tpu_torch", "dsptoolbox_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == base
    for name in ("dsptoolbox_tpu.x", "jax", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) - base == {
        "dsptoolbox_tpu.x", "jax", "jaxlib.xla_client", "flax.linen"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        tops = {m.split(".")[0] for m in imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "dsptoolbox_tpu"}, path
        if "reference" in path.parts:
            assert "dsptoolbox_tpu_torch" not in tops, path


def test_no_card_no_result():
    r = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "session16x60.spectral",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)},
    )
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    for line in r.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except json.JSONDecodeError:
            pass
