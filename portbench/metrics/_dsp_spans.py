"""The port's own spans in a traced stretch: the CPU events named
``dsp.<layer>.*`` (``dsp.entry``, ``dsp.ops``, ``dsp.build``) that
``dsptoolbox_tpu_torch._trace`` records while the profiler runs, on the
profiler's clock with the device's operations. Not a metric: the helpers
of the readers ``entry_host_ms``, ``ops_host_ms``, ``host_stall_ms``,
``host_syncs`` and ``operator_build_s``. A program without such spans (one
older than its tracer) gives them nothing to read.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

PREFIX = "dsp."
# host calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
TOP = 5
# points located a chunk at a time: a chunk × spans boolean matrix
CHUNK = 256


def spans(trace):
    """``(names, intervals (n, 2) in us)`` of the trace's ``dsp.`` events,
    by start; None where there are none."""
    idx = [i for i, n in enumerate(trace.cpu_names) if n.startswith(PREFIX)]
    if not idx:
        return None
    return [trace.cpu_names[i] for i in idx], trace.cpu_iv[idx]


def self_us(iv: np.ndarray) -> np.ndarray:
    """Each span's self time: its duration less the part its child spans
    cover. Spans of one thread nest, so a span's children are the spans
    that start inside it before it ends, and they do not overlap."""
    order = np.lexsort((-iv[:, 1], iv[:, 0]))
    out = iv[:, 1] - iv[:, 0]
    stack: list = []
    for k in order:
        s, e = iv[k]
        while stack and iv[stack[-1], 1] <= s:
            stack.pop()
        if stack:
            p = stack[-1]
            out[p] -= min(e, iv[p, 1]) - s
        stack.append(k)
    return out


def layer_self_ms(run, layer: str):
    """Self time a call, in ms, of the spans of ``layer``; None without a
    trace or without the program's spans."""
    t = run.trace
    got = None if t is None else spans(t)
    if got is None:
        return None
    names, iv = got
    own = self_us(iv)
    mask = np.asarray([n.startswith(f"{PREFIX}{layer}.") for n in names])
    return float(own[mask].sum()) * 1e-3 / t.n_calls


def innermost(iv: np.ndarray, points: np.ndarray) -> np.ndarray:
    """For each point, the index of the innermost span (the latest to
    start) holding it; -1 where none does."""
    out = np.full(len(points), -1)
    starts = iv[:, 0]
    for a in range(0, len(points), CHUNK):
        p = points[a:a + CHUNK, None]
        inside = (iv[None, :, 0] <= p) & (iv[None, :, 1] >= p)
        latest = np.where(inside, starts[None, :], -np.inf)
        hit = inside.any(axis=1)
        out[a:a + CHUNK] = np.where(hit, latest.argmax(axis=1), -1)
    return out


def idle_gaps(trace) -> np.ndarray:
    """The device's idle gaps ``(n, 2)`` inside the window: the complement
    of the union of its operations' intervals."""
    busy = trace.busy_intervals()
    edges = np.concatenate([[trace.window[0]], busy.ravel(), [trace.window[1]]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def stalls(run):
    """``(ms a call, Counter of us by innermost span)`` of the idle gaps
    whose midpoint lies in a ``dsp.`` span; None without a trace or without
    the program's spans."""
    t = run.trace
    got = None if t is None else spans(t)
    if got is None:
        return None
    names, iv = got
    gaps = idle_gaps(t)
    where = innermost(iv, gaps.mean(axis=1))
    by = Counter()
    for (s, e), k in zip(gaps, where):
        if k >= 0:
            by[names[k]] += e - s
    return sum(by.values()) * 1e-3 / t.n_calls, by


def syncs(run):
    """``(count a call, Counter by innermost span)`` of the host's waits
    for the device (`SYNCS`) that start inside a ``dsp.`` span; None
    without a trace or without the program's spans."""
    t = run.trace
    got = None if t is None else spans(t)
    if got is None:
        return None
    names, iv = got
    starts = np.asarray([t.cpu_iv[i, 0] for i, n in enumerate(t.cpu_names) if n in SYNCS])
    by = Counter(names[k] for k in innermost(iv, starts) if k >= 0)
    return sum(by.values()) / t.n_calls, by


def top(by: Counter, scale: float, unit: str = "") -> str:
    """The `TOP` largest entries of ``by``, each times ``scale``."""
    return "; ".join(f"{n} {v * scale:.4g}{unit}" for n, v in by.most_common(TOP)) or "none"
