"""Host ms per build of the tree's root read (`blaze.tree.root`: every
layer out of Montgomery form on K1, then the root's copy to the host), in
the traced window."""
from zkbench import marks


def read(run):
    t = run.trace
    roots = [] if run.peaks is None or t is None else marks.spans(t, "blaze.tree.root")
    return sum(b - a for a, b in roots) / 1e3 / len(run.records) if roots else None
