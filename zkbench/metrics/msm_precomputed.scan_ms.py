"""Device ms per MSM of the chunks' K2 scan (the gathered form, at two
windows a chunk in the precompute mode's 32-bit slices): the operations
from each mark_msm_scan to the next mark, in the traced window."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stage_s(t, "msm_scan")
    return None if s is None else 1e3 * s / len(run.records)
