"""host_stall_ms.<cell>: ms per job of the traced window in which no device
operation ran, in stretches whose midpoint lies under one of the
program's `blaze.*` spans: the device's idle time put down to the
program's host path (the rest is the harness's)."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stall_s(t)
    return None if s is None else 1e3 * s / len(run.records)
