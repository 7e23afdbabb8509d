"""Metric readers, one file a metric named as in ``BENCHMARK.json``
(``harness.part`` loads them by path, as a name may hold dots):
``read(run)`` returns the value, or None where the run has nothing to
read; an optional ``note(run)`` says how it was taken."""
