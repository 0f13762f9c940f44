"""The port's tracing: spans on torch.profiler's timeline, stage marks on the
device, and the checks that hold a device trace to the launch counters.

  * `span(name, label=None)`: a `torch.profiler.record_function` while a
    torch profiler runs, else a shared no-op.  Spans land on the profiler's
    own timeline, on the device trace's clock, and are written out with it.
    Names are `blaze.<layer>.<step>`; a client's span carries the label of
    its task after a `#` (`blaze.poseidon.start#3`), so the spans of one
    job share it.
  * `mark(stage, like, clock=None)`: a one-thread kernel
    (`csrc/trace_marks.cu`, `mark_<stage>_kernel`) on `like`'s current
    stream; nothing on a CPU tensor.  A CUDA graph captured over marks
    replays them, so the stages of a chunk's graph show in the device trace
    by name.  `StageClock` owns the device array the marks time into
    (%globaltimer, mark to mark) and reads it back: a per-stage split of a
    whole run with no profiler.
  * `launch_key`, `traced_launches`, `check_trace`, `TraceLost`: a trace's
    device kernels by launch-counter key (`_build.LAUNCHES`), and the check
    that it lost none of the launches the counters saw; `device_ops`, a
    profile's device operations without the spans' device-side ranges.

Import `torch.profiler` and load the marks' library only when used.
"""
from __future__ import annotations

import contextlib
import ctypes
import re

import torch

from . import _build
from .utils.errors import LoadFailed

# ------------------------------------------------------------------- spans
_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str, label=None):
    """A span `name` (`blaze.<layer>.<step>`) on the running torch
    profiler's timeline, `#label` appended where given; a shared no-op
    context when no profiler runs."""
    if not _profiling():
        return _NO_SPAN
    from torch.profiler import record_function

    return record_function(name if label is None else f"{name}#{label}")


# ------------------------------------------------------------------- marks
# Stages in csrc/trace_marks.cu's order; each mark opens its stage, and
# msm_done closes the last one (what runs after it goes to no stage).
MSM_STAGES = ("msm_sort", "msm_layout", "msm_scan", "msm_bucket", "msm_stream")
MARKS = (*MSM_STAGES, "msm_done")
CLOCK_WORDS = 3 + len(MSM_STAGES)


def _mark_entry():
    lib = _build.load("trace_marks")
    fn = lib.blz_mark
    if fn.argtypes is None:
        words = lib.blz_mark_clock_words
        words.argtypes, words.restype = [], ctypes.c_int
        if words() != CLOCK_WORDS:
            raise LoadFailed(f"trace_marks.cu's clock holds {words()} words, "
                             f"trace.py reads {CLOCK_WORDS}")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mark(stage: str, like: torch.Tensor, clock: torch.Tensor | None = None) -> None:
    """Launch stage `stage`'s mark on the current stream of `like`'s card,
    timing into `clock` (a StageClock's array on that card) where given;
    on a CPU tensor, nothing."""
    if like.device.type != "cuda":
        return
    index = MARKS.index(stage)
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = _mark_entry()(index, None if clock is None else clock.data_ptr(), stream)
    _build.check(rc, f"mark {stage}")
    _build.LAUNCHES[f"mark_{stage}"] += 1


class StageClock:
    """Device time per MSM stage, mark to mark, summed over every call since
    it was made: one int64 array per card, made at the first mark there
    (outside any graph capture: a capture's warm-up or a call's first mark
    makes it first), and read back by `ms()`.  Marks from one caller at a
    time: two streams marking into one clock mix their stages."""

    def __init__(self):
        self._clocks: dict = {}

    def mark(self, stage: str, like: torch.Tensor) -> None:
        if like.device.type != "cuda":
            return
        key = str(like.device)
        clock = self._clocks.get(key)
        if clock is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("StageClock: the clock is made before a capture, not in one")
            clock = self._clocks[key] = torch.zeros(CLOCK_WORDS, dtype=torch.int64,
                                                    device=like.device)
        mark(stage, like, clock)

    def ms(self) -> dict:
        """{stage without `msm_`: device ms summed, ..., "calls": msm_done
        marks}, over every card's clock (one small copy from each)."""
        sums = [0] * (len(MSM_STAGES) + 1)
        for clock in self._clocks.values():
            sums = [a + b for a, b in zip(sums, clock.cpu().tolist()[2:])]
        out = {s.removeprefix("msm_"): ns / 1e6 for s, ns in zip(MSM_STAGES, sums)}
        out["calls"] = sums[-1]
        return out


# ------------------------------------------------------- the trace checks
class TraceLost(RuntimeError):
    """The profiler recorded fewer device events of a kernel than the
    port's launch counters say were launched in the traced window.  On the
    H100 machine torch.profiler drops device events as out of its window in
    a process older than about 40 s, and all of a short window's from about
    100 s on (scripts/profiler_probe.py, PERF.md §7)."""


def dev_us(e) -> float:
    """A profiler event's own device time (us), across torch versions."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ops(prof) -> list:
    """The key averages of a profile's device operations (kernels, copies,
    fills): its CUDA events with device time of their own, less the
    device-side ranges the profiler draws for each span (user
    annotations), which cover those operations again."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def launch_key(kernel_name: str) -> str | None:
    """The launch-counter key of a device kernel's name (mont_mul_kernel,
    mul_lm_rows_kernel<8>, mark_msm_sort_kernel, ...; an NTT kernel's W = 12
    build, such as ntt_base_kernel<12, 9>, under name_w12), or None for a
    kernel of another library."""
    if "kernel" not in kernel_name:
        return None
    key = next((k for k in _build.LAUNCHES if k + "_" in kernel_name), None)
    wide = f"{key}_w12"
    if wide in _build.LAUNCHES and re.search(r"_kernel<12\b", kernel_name):
        return wide
    return key


def traced_launches(events) -> dict:
    """{launch-counter key: count} of a trace's (device kernel name, count)
    pairs."""
    out = {}
    for name, count in events:
        key = launch_key(name)
        if key:
            out[key] = out.get(key, 0) + count
    return out


def check_trace(traced: dict, launched: dict, what: str) -> None:
    """Raise TraceLost unless the trace holds a device event for every
    launch the counters saw: `traced` and `launched` map launch-counter
    keys to counts."""
    lost = {k: [v, traced.get(k, 0)] for k, v in launched.items() if v > traced.get(k, 0)}
    if lost:
        raise TraceLost(f"{what}: the profiler lost device events, kernel: "
                        f"[launched, traced] {lost}")
