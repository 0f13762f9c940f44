"""Device ms per MSM of the chunks' layout stage (the sorted point gather,
the sign row, the pad and K2's contiguous rows): the operations from each
mark_msm_layout to the next mark, in the traced window."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stage_s(t, "msm_layout")
    return None if s is None else 1e3 * s / len(run.records)
