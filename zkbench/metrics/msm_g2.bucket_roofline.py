"""The bucket stage's share of its roofline in the G2 cell, in %: the least
time of one MSM's bucket reduction (the job's bucket_work(): 2 (2^c - 1)
complete adds a window, once an MSM) over the device seconds per MSM of
the msm_bucket stage (each mark_msm_bucket to the next mark: the lane
prefix, K4, K5, K3, KF, once a chunk).  None where the job counts no
bucket work or the trace holds no mark."""
from zkbench import marks, work


def read(run):
    t, job = run.trace, run.job
    if run.peaks is None or t is None or not hasattr(job, "bucket_work"):
        return None
    s = marks.stage_s(t, "msm_bucket")
    if not s:
        return None
    return 100.0 * work.bound_s(job.bucket_work(), run.peaks)[0] * len(run.records) / s
