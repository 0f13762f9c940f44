"""Device ms per MSM in operations that are not the program's own kernels
(no launch-counter key matches their name): the chunk's sorts, gathers,
copies and cats, in the traced window."""


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not t.device:
        return None
    return 1e3 * t.device_s(*t.window, kernels=False) / len(run.records)
