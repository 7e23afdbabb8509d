"""Host seconds the port spent building device constants since the
process started (``dsptoolbox_tpu_torch._trace.builds``: the misses of
every ``_config.device_cache`` builder), most of them in set-up."""

import sys
from collections import Counter

TRACE_MODULE = "dsptoolbox_tpu_torch._trace"


def _builds():
    mod = sys.modules.get(TRACE_MODULE)
    return None if mod is None else mod.builds


def read(run):
    builds = _builds()
    if run.trace is None or builds is None:
        return None
    return float(sum(s for _, s in builds.values()))


def note(run):
    builds = _builds()
    again = Counter(n for n in run.trace.cpu_names if n.startswith("dsp.build."))
    slow = sorted(builds.items(), key=lambda kv: -kv[1][1])[:5]
    return (f"{sum(c for c, _ in builds.values())} builds, longest "
            + "; ".join(f"{k} {c}x {s:.4g} s" for k, (c, s) in slow)
            + f"; built again in the traced stretch: {sum(again.values())}"
            + "".join(f"; {k} {c}x" for k, c in again.most_common(5)))
