"""Per build, the host's start -> wait -> root span less the device time of
the program's kernels that started in it, in ms (mean over the traced
builds): what the tree builder and the client add around K10 and K1."""


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not t.jobs:
        return None
    per = [(b - a) / 1e6 - t.device_s(a, b, kernels=True) for a, b in t.jobs]
    return 1e3 * sum(per) / len(per)
