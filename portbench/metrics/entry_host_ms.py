"""Host time a call in the port's public calls themselves (their own
Python: argument checks, caches' keys, the class layer): the self time of
the ``dsp.entry.*`` spans, less the ``dsp.`` spans under them, over the
traced calls."""

from portbench.metrics._dsp_spans import layer_self_ms


def read(run):
    return layer_self_ms(run, "entry")
