"""Device ms per MSM of the chunks' bucket stage (the lane prefix, the
bound gathers and `where`s, K5, K4, K3 and KF): the operations from each
mark_msm_bucket to the next mark, in the traced window."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stage_s(t, "msm_bucket")
    return None if s is None else 1e3 * s / len(run.records)
