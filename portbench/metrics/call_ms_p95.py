"""The 95th percentile of every window call's latency, from its start to
the end of the `torch.cuda.synchronize()` that follows it, on the host
clock (numpy's linear interpolation)."""

import numpy as np


def read(run):
    lat = np.asarray([t2 - t0 for t0, _, t2 in run.calls]) * 1e3
    return float(np.percentile(lat, 95))


def note(run):
    lat = np.asarray([t2 - t0 for t0, _, t2 in run.calls]) * 1e3
    return (f"{len(lat)} calls; median {float(np.median(lat)):.4f} ms, "
            f"{int((lat > np.percentile(lat, 95)).sum())} beyond the 95th percentile")
