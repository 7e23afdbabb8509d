"""Host time a call in the port's ops (planning, windows, operator
lookups, torch's dispatch of their operations): the self time of the
``dsp.ops.*`` spans, less the ``dsp.`` spans under them, over the traced
calls."""

from portbench.metrics._dsp_spans import layer_self_ms


def read(run):
    return layer_self_ms(run, "ops")
