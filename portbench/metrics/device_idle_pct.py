"""The device's idle share of the traced window: 1 - (the union of every
device operation's interval) / (the window's wall time), both from the
same trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
