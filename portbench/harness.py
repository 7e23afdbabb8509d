"""The benchmark's runner, driven by ``BENCHMARK.json``: it finds a cell's
configuration, traffic mix, chain, reference, limits and metrics by name,
sets up, runs the closed loop, traces, judges the outputs and builds the
result line. Nothing here names a cell, a configuration or a metric.

Files, by the names in ``BENCHMARK.json`` and the traffic mix:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the ``chain`` the mix drives;
- ``inputs/<kind>.py``: the generator of the configuration's ``input``;
- ``chains/<chain>.py``: the program's set-up, call and outputs, and the
  work of a call; ``reference/<chain>.py``: the plain reference, the rows
  it compares and the control;
- ``limits/<workload>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``.

Every mix is a closed loop of one client, one call in flight.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import trace as tr

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# seconds of calls traced after the window in a ``--trace 1`` run
TRACE_SECONDS = 2.0
FORBIDDEN = ("jax", "jaxlib", "flax", "dsptoolbox_tpu")
# the pool of recordings a run cycles through, and the calls of the warm-up
RECORDINGS = 4
WARMUP_CALLS = 3
# the early window call judged is drawn from the first this many
JUDGED_EARLY_CALLS = 8


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def part(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded by its path, since
    a name may hold dots (``dispatch_ms.serve``)."""
    full = f"{__package__}.{kind}.{name}"
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(full, BENCH / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return sys.modules[full]


@dataclass
class Cell:
    """One workload of the manifest, with everything found by its names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    chain: object
    reference: object
    limits: dict
    end_to_end: list
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or in
    every cell where it has no list."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(manifest: dict, name: str, config: dict | None = None) -> Cell:
    """The cell ``name`` of ``manifest``; ``config`` replaces the
    configuration's file (the tests run tiny copies)."""
    wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    config = config or load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    return Cell(name, int(wl["chips"]), config, traffic,
                part("chains", traffic["chain"]), part("reference", traffic["chain"]),
                load_json(BENCH / "limits" / f"{name}.json"),
                [m for m in manifest["end_to_end"] if applies(m, name)],
                [m for m in manifest["per_layer"] if applies(m, name)])


@dataclass
class RunRecord:
    """What the metric readers read: host-clock times of the window's
    calls ``(start, returned, synchronized)``, the window's length, the
    set-up time, a call's work, and the traced stretch."""

    setup_s: float
    calls: list
    window_s: float
    work: dict
    trace: tr.TraceRecord | None = None
    card: str = "not read"
    notes: list = field(default_factory=list)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list:
    """Modules whose top-level name (before the first dot, compared whole)
    is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _launch_counters() -> dict:
    """The port's kernel launch counters (``ops.cuda_*.launches``)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("dsptoolbox_tpu_torch.ops.cuda_") and hasattr(mod, "launches"):
            out[name.rsplit(".", 1)[-1]] = int(mod.launches)
    return out


def _log(msg: str) -> None:
    print(msg, flush=True)


class Loop:
    """The closed loop: one client, one call in flight; each call starts
    when the previous call's synchronize has returned. Keeps the outputs of
    the call ``keep`` and of the last call for the comparison."""

    def __init__(self, program, order: list, sync, keep: int):
        self.program, self.order, self.sync, self.keep = program, order, sync, keep
        self.n = 0
        self.failed = 0
        self.kept = None
        self.last = None

    def run(self, seconds: float, span) -> list:
        calls = []
        deadline = time.perf_counter() + seconds
        while True:
            rec = self.order[self.n % len(self.order)]
            t0 = time.perf_counter()
            try:
                with span("call"):
                    out = self.program.call(rec, span)
            except Exception:  # a failed call is counted, and judged not correct
                if not self.failed:
                    traceback.print_exc()
                self.failed += 1
                out = None
            t1 = time.perf_counter()
            with span("sync"):
                self.sync()
            t2 = time.perf_counter()
            calls.append((t0, t1, t2))
            if self.n == self.keep:
                self.kept = (rec, out)
            self.last = (rec, out)
            self.n += 1
            if t2 >= deadline:
                return calls


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        program_factory=None) -> dict:
    """One run of ``cell``: set-up, warm-up, the window of ``seconds``,
    with ``trace`` the traced stretch, the comparison; returns the result
    line's object (with ``checks`` last). ``program_factory`` puts another
    program (the control, a planted fault) in the chain's place."""
    import torch

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    rng = np.random.default_rng([int(seed), 0x5EED])
    start = int(rng.integers(RECORDINGS))
    order = [(start + i) % RECORDINGS for i in range(RECORDINGS)]
    keep = int(rng.integers(JUDGED_EARLY_CALLS))
    rows = cell.reference.sample_rows(cell.config, rng)

    inputs = part("inputs", cell.config["input"]["kind"])
    recordings = inputs.make(cell.config, RECORDINGS, seed, device)
    factory = program_factory or cell.chain.Program
    program = factory(cell.config, cell.traffic, recordings, device, rows)
    work = cell.chain.work(cell.config, cell.traffic)

    # warm-up: every shape of the cell's calls, with one call's outputs held
    # and the previous call's alive through each call, as the window holds
    # the judged call's, the last call's and the current one's
    untraced = tr.spans(False)
    held = program.call(order[0], untraced)
    prev = None
    for i in range(1, WARMUP_CALLS):
        prev = program.call(order[i % RECORDINGS], untraced)
    del held, prev
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    built = {}
    if "dsptoolbox_tpu_torch._cuda" in sys.modules:
        built = {k: v["seconds"] for k, v in sys.modules["dsptoolbox_tpu_torch._cuda"].BUILD_LOG.items()}
    _log(f"setup_s {setup_s:.3f}; kernels built in this run (s): {built or 'none'}")

    loop = Loop(program, order, sync, keep)
    before = _launch_counters()
    calls = loop.run(seconds, untraced)
    after = _launch_counters()
    _log("launches a call: " + (", ".join(
        f"{k} {(after[k] - before.get(k, 0)) / len(calls):g}" for k in sorted(after)) or "none"))
    record = RunRecord(setup_s, calls, calls[-1][2] - calls[0][0], work)

    if trace:
        prof = tr.profiler()
        prof.start()
        loop.run(TRACE_SECONDS, tr.spans(True))
        prof.stop()
        t0 = time.perf_counter()
        record.trace = tr.summarize(prof)
        del prof
        _log(f"trace: {'no device operation seen' if record.trace is None else f'{record.trace.n_calls} calls'}"
             f", read in {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        record.card = card_line()

    # the outputs judged, read back; the program's state freed before the reference
    judged = [loop.kept] if loop.kept is not None else []
    if loop.last is not loop.kept:
        judged.append(loop.last)
    got = [(rec, None if out is None else program.extract(out, rows)) for rec, out in judged]
    failed = loop.failed
    del judged, program, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks: dict = {}
    from .compare import merge

    for rec, g in got:
        found = {k: float("nan") for k in cell.limits} if g is None else \
            cell.reference.compare(cell.config, recordings[rec], g, rows)
        checks = merge(checks, found)
    _log(f"compared {len(got)} calls on {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    attempted = len(calls) + (record.trace.n_calls if record.trace else 0)
    correct = not failed and bool(got) and set(checks) == set(cell.limits) and all(
        math.isfinite(v) and v <= cell.limits[k] for k, v in checks.items())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = part("metrics", m["name"])
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        note = getattr(reader, "note", None)
        if note is not None and value is not None:
            _log(f"{m['name']}: {note(record)}")
    device_info = {"platform": "gpu" if on_card else torch.device(device).type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and record.trace is not None:
        device_info["busy_s"] = record.trace.busy_s
        device_info["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    # a number that is missing or not finite reads null
    result["checks"] = {k: {"value": v if v is not None and math.isfinite(v) else None,
                            "limit": lim}
                        for k, lim in cell.limits.items() for v in [checks.get(k)]}
    return result
