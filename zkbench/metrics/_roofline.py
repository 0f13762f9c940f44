"""<job>_roofline: the least time of one job's work at the cell's sizes
(zkbench/work.py: the larger of bytes over HBM bandwidth and IMADs over
the IMAD rate) over the device's busy seconds per job in the traced
window, in %."""
from zkbench import work


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not run.records or t.busy_s <= 0:
        return None
    return 100.0 * work.bound_s(run.job.work(), run.peaks)[0] * len(run.records) / t.busy_s
