"""The host's waits for the device a call inside the port: the
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and synchronous ``cudaMemcpy`` events that start
inside a ``dsp.`` span (the harness's own synchronize lies outside every
such span)."""

from portbench.metrics._dsp_spans import syncs, top


def read(run):
    got = syncs(run)
    return None if got is None else got[0]


def note(run):
    return "innermost spans, syncs a call: " + top(syncs(run)[1], 1 / run.trace.n_calls)
