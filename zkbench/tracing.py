"""A traced stretch of a run: torch.profiler over the jobs, its Chrome trace
read back into device operations, host operations and the harness's own
spans, and checked against the program's launch counters.

On the H100 machine torch.profiler drops the card's events once a process
is about 40 s old, so the harness traces a short stretch right after
set-up, and a trace that holds fewer events of a kernel than the launch
counters rose by fails the run (`TraceLost`): no metric is read from a
partial trace.
"""
from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "zkbench.window"
JOB = "zkbench.job"


class TraceLost(RuntimeError):
    """The trace misses device events of launches the counters saw."""


def launch_key(kernel_name: str, keys) -> str | None:
    """The launch-counter key of a device kernel's name (mont_mul_kernel,
    mul_lm_rows_kernel<8>, ...; a W = 12 build such as ntt_base_kernel<12,
    9> under name_w12), or None for an operation that is not the
    program's own kernel (a copy, a sort, a gather)."""
    if "kernel" not in kernel_name:
        return None
    key = next((k for k in keys if k + "_" in kernel_name), None)
    if key and f"{key}_w12" in keys and re.search(r"_kernel<12\b", kernel_name):
        return f"{key}_w12"
    return key


def check_trace(traced: dict, launched: dict, what: str) -> None:
    """Raise TraceLost unless the trace holds a device event for every
    launch the counters saw (both map launch-counter keys to counts)."""
    lost = {k: [v, traced.get(k, 0)] for k, v in launched.items() if v > traced.get(k, 0)}
    if lost:
        raise TraceLost(f"{what}: the profiler lost device events, kernel: "
                        f"[launched, traced] {lost}")


def union(spans) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One traced stretch.  Times are the trace's microseconds."""

    def __init__(self, events: list, launched: dict, keys):
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in xs
                       if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in xs
                     if e.get("cat") in HOST_CATS]
        windows = [(ts, ts + d) for n, ts, d in self.host if n == WINDOW]
        if len(windows) != 1:
            raise TraceLost(f"the trace holds {len(windows)} {WINDOW} spans, want 1")
        self.window = windows[0]
        self.jobs = sorted((ts, ts + d) for n, ts, d in self.host if n == JOB)
        self.keys = tuple(keys)
        traced = {}
        for name, _, _ in self.device:
            k = launch_key(name, self.keys)
            if k:
                traced[k] = traced.get(k, 0) + 1
        check_trace(traced, launched, "traced window")

    # ------------------------------------------------------------- reads
    def is_kernel(self, name: str) -> bool:
        """Whether a device operation is one of the program's own kernels."""
        return launch_key(name, self.keys) is not None

    def busy(self, lo: float | None = None, hi: float | None = None) -> list:
        """The union of device operations' intervals clipped to [lo, hi]
        (default: the window)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        spans = [(max(ts, lo), min(ts + d, hi)) for _, ts, d in self.device
                 if ts < hi and ts + d > lo]
        return union(spans)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_s(self, lo: float, hi: float, kernels: bool | None = None) -> float:
        """Seconds of device operations that start in [lo, hi): all of them,
        or only the program's kernels (True) or only the rest (False)."""
        return sum(d for n, ts, d in self.device if lo <= ts < hi and (
            kernels is None or self.is_kernel(n) == kernels)) / 1e6

    def top_device_ops(self, count: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        tot = {}
        for n, ts, d in self.device:
            if self.window[0] <= ts < self.window[1]:
                tot[n] = tot.get(n, 0.0) + d / 1e6
        return [[n[:120], s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list:
        """[[what the host was doing, seconds]] of the longest stretches of
        the window in which no device operation ran: the innermost host
        operation or span around each gap's middle."""
        lo, hi = self.window
        edges = [lo] + [x for span in self.busy() for x in span] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:count]:
            mid = (a + b) / 2
            around = [(d, n) for n, ts, d in self.host if ts <= mid <= ts + d]
            out.append([min(around)[1][:120] if around else "untraced host time",
                        (b - a) / 1e6])
        return out


def profile(fn, counters: dict, cuda: bool = True):
    """fn() under torch.profiler (CPU and, on a card, CUDA activities)
    inside a `zkbench.window` span; returns (fn's result, Trace).
    `counters` is the program's launch-counter dict, read before and
    after."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    before = dict(counters)
    with tprofile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in counters.items() if v != before.get(k, 0)}
    with tempfile.TemporaryDirectory(prefix="zkbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return out, Trace(events, launched, tuple(counters))
