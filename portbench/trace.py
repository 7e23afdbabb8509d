"""The traced stretch of a run: `torch.profiler` (CPU and CUDA activities)
over whole calls, reduced to the device's operations and busy time, the
window's length and the host's spans, all on the profiler's one clock.

The harness marks each call (``portbench.call``), each of the chain's
steps (``portbench.<step>``) and each synchronize (``portbench.sync``)
with `record_function`, so the window runs from the first call's start to
the last synchronize's end, and every idle gap of the device is labelled
by what the host was doing in it.
"""

from __future__ import annotations

import re
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

PREFIX = "portbench."
# idle gaps labelled one by one, longest first
GAPS_LABELLED = 500
TOP = 10
NAME_CHARS = 160


def spans(active: bool):
    """A factory of the harness's spans: `record_function` while tracing,
    else nothing."""
    if not active:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function(PREFIX + name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged ``(start, end)`` rows of the intervals ``iv``."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


@dataclass
class TraceRecord:
    """Device operations ``(name, start_us, end_us)`` inside the window,
    the window ``(start_us, end_us)``, the calls traced, and the host's
    events for the gaps' labels."""

    device_ops: list
    window: tuple
    n_calls: int
    cpu_names: list
    cpu_iv: np.ndarray

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> np.ndarray:
        iv = np.asarray([(s, e) for _, s, e in self.device_ops], dtype=np.float64).reshape(-1, 2)
        return _union(np.clip(iv, *self.window))

    @property
    def busy_s(self) -> float:
        u = self.busy_intervals()
        return float((u[:, 1] - u[:, 0]).sum()) * 1e-6

    def seconds_of(self, names) -> float | None:
        """Device seconds of the operations whose name holds one of
        ``names`` as a whole word; None when none ran."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        hits = [e - s for n, s, e in self.device_ops if pat.search(n)]
        return sum(hits) * 1e-6 if hits else None

    def seconds_except(self, names) -> float:
        """Device seconds of every operation not named in ``names``."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(e - s for n, s, e in self.device_ops if not pat.search(n)) * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing (the innermost host event at the gap's
        middle, under the harness's step), each as ``[name, seconds]``."""
        by_op: dict = {}
        for n, s, e in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        busy = self.busy_intervals()
        edges = np.concatenate([[self.window[0]], busy.ravel(), [self.window[1]]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:GAPS_LABELLED]
        by_label: dict = {}
        starts, ends = self.cpu_iv[:, 0], self.cpu_iv[:, 1]
        for s, e in gaps:
            m = 0.5 * (s + e)
            idx = np.nonzero((starts <= m) & (ends >= m))[0]
            step = [self.cpu_names[i] for i in idx
                    if self.cpu_names[i].startswith(PREFIX) and self.cpu_names[i] != PREFIX + "call"]
            inner = [i for i in idx if not self.cpu_names[i].startswith(PREFIX)]
            label = step[-1][len(PREFIX):] if step else "between calls"
            if inner:
                label += " > " + self.cpu_names[max(inner, key=lambda i: starts[i])]
            by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-6
        labelled = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": [[n[:NAME_CHARS], v] for n, v in labelled]}


def summarize(prof) -> TraceRecord | None:
    """The trace of ``prof`` over its calls; None when it has no call span
    or no device operation (the profiler saw nothing of the card)."""
    from torch.autograd import DeviceType

    dev, cpu_names, cpu_iv, calls, syncs = [], [], [], [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            # the harness's own spans are mirrored on the device's timeline:
            # they are annotations, not operations
            if not ev.name.startswith(PREFIX):
                dev.append((ev.name, s, e))
            continue
        cpu_names.append(ev.name)
        cpu_iv.append((s, e))
        if ev.name == PREFIX + "call":
            calls.append((s, e))
        elif ev.name == PREFIX + "sync":
            syncs.append((s, e))
    if not calls or not dev:
        return None
    window = (min(s for s, _ in calls), max(e for _, e in syncs + calls))
    order = np.argsort([s for s, _ in cpu_iv]) if cpu_iv else []
    cpu_names = [cpu_names[i] for i in order]
    cpu_iv = np.asarray([cpu_iv[i] for i in order], dtype=np.float64).reshape(-1, 2)
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in dev
              if e > window[0] and s < window[1]]
    return TraceRecord(inside, window, len(calls), cpu_names, cpu_iv)
