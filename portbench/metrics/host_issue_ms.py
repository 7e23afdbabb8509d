"""Host time a call takes to return, before its synchronize: the mean over
the window's calls (the untraced calls of a ``--trace 1`` run, so the
profiler's own cost is not in it)."""


def read(run):
    return sum(t1 - t0 for t0, t1, _ in run.calls) / len(run.calls) * 1e3
