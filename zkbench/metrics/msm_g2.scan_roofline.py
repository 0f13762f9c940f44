"""K2's share of its roofline in the G2 cell, in %: the least time of one
MSM's per-window mixed adds (the job's scan_work(), zkbench/work.py's
limits) over the device seconds per MSM of the msm_scan stage (each
mark_msm_scan to the next mark).  None where the job counts no scan work
or the trace holds no mark."""
from zkbench import marks, work


def read(run):
    t, job = run.trace, run.job
    if run.peaks is None or t is None or not hasattr(job, "scan_work"):
        return None
    s = marks.stage_s(t, "msm_scan")
    if not s:
        return None
    return 100.0 * work.bound_s(job.scan_work(), run.peaks)[0] * len(run.records) / s
