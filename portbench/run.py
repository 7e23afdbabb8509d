"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Without a CUDA device (or with fewer
devices than the cell asks for), without the port beside the benchmark, or
with JAX or the JAX package loaded once the window has closed, it exits
with another code than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a library could write goes to a fixed directory inside the
# checkout (the port's own kernels build into dsptoolbox_tpu_torch/_build/)
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(CACHE / sub)


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available():
        fail(3, "no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"{torch.cuda.device_count()} CUDA devices, the cell asks for {cell.chips}")
    import dsptoolbox_tpu_torch

    if ROOT not in Path(dsptoolbox_tpu_torch.__file__).resolve().parents:
        fail(4, f"dsptoolbox_tpu_torch comes from {dsptoolbox_tpu_torch.__file__}, "
                f"not from the checkout {ROOT}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)

    found = harness.forbidden_modules()
    if found:
        fail(5, "JAX or the JAX package is loaded: " + ", ".join(found))
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
