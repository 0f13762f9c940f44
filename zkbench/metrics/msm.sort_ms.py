"""Device ms per MSM of the chunks' sort stage (digits, signed recode,
argsort, histogram, bucket bounds): the operations from each
mark_msm_sort to the next mark, in the traced window."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stage_s(t, "msm_sort")
    return None if s is None else 1e3 * s / len(run.records)
