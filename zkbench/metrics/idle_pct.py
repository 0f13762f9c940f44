"""idle_pct.<cell>: the share of the traced window in which no device
operation ran (the union of the trace's device intervals), in %."""


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
