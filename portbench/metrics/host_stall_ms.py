"""Device idle a call that the port's own host work causes: the traced
window's idle gaps (outside the union of the device's operations) whose
midpoint lies in a ``dsp.`` span. The harness's time between calls and
its synchronize lie outside every such span."""

from portbench.metrics._dsp_spans import stalls, top


def read(run):
    got = stalls(run)
    return None if got is None else got[0]


def note(run):
    n = run.trace.n_calls
    return "innermost spans, idle a call: " + top(stalls(run)[1], 1e-3 / n, " ms")
