"""What the program's own instruments leave in a trace, for the per-layer
readers: its stage marks (one-thread kernels `mark_<stage>_kernel`, device
operations between the stages of an MSM chunk's CUDA graph) and its spans
(host `blaze.<layer>.<step>` ranges, a client's followed by `#<task
label>`).  A program without them leaves neither, and every read here
then returns None."""
from __future__ import annotations

import bisect
import re

from zkbench import tracing

MARK = re.compile(r"\bmark_(\w+?)_kernel\b")
SPAN = "blaze."


def stage_s(trace, stage: str) -> float | None:
    """Seconds of the window's device operations that start from a mark of
    `stage` (the mark included) up to the next mark of any stage, or None
    where the window holds no mark."""
    lo, hi = trace.window
    current, total, marked = None, 0.0, False
    for name, ts, dur in sorted((e for e in trace.device if lo <= e[1] < hi),
                                key=lambda e: e[1]):
        m = MARK.search(name)
        if m:
            current, marked = m[1], True
        if current == stage:
            total += dur
    return total / 1e6 if marked else None


def spans(trace, name: str | None = None) -> list:
    """(start, end) of the window's program spans, all of them or those
    named `name` (whatever their label), sorted."""
    lo, hi = trace.window
    return sorted((ts, ts + d) for n, ts, d in trace.host
                  if n.startswith(SPAN) and lo <= ts < hi
                  and (name is None or n.split("#", 1)[0] == name))


def stall_s(trace) -> float | None:
    """Seconds of the window in which no device operation ran and whose
    stretch's midpoint lies under a program span: the device waiting on the
    program's host path.  None where the window holds no program span."""
    under = tracing.union(spans(trace))
    if not under:
        return None
    starts = [a for a, _ in under]
    lo, hi = trace.window
    edges = [lo] + [x for span in trace.busy() for x in span] + [hi]
    total = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if b > a and i >= 0 and mid <= under[i][1]:
            total += b - a
    return total / 1e6
