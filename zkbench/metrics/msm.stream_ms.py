"""Device ms per MSM between the chunks (each chunk's output clone, the
accumulation on K3, the next chunk's operand copies, the fold on K6): the
operations from each mark_msm_stream to the next mark, in the traced
window."""
from zkbench import marks


def read(run):
    t = run.trace
    s = None if run.peaks is None or t is None else marks.stage_s(t, "msm_stream")
    return None if s is None else 1e3 * s / len(run.records)
