"""The controls: the plain reference put in the program's place, in the
precision below the configuration's (``reference/<chain>.py:Control``),
driven by the harness as the program is, on a short window, and judged by
the same comparison. A sound limit fails it.

    python -m portbench.control --workload <name> --seeds <n> [<n> ...] [--seconds 1]

Prints one JSON line a seed with the numbers compared, and exits with 1
if any control came out correct. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    passed = 0
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                        time.perf_counter(), program_factory=cell.reference.Control)
        passed += r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "bf16",
                          "correct": r["correct"], "checks": r["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
