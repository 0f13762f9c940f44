"""The readers of the program's own instruments (zkbench/marks.py and the
metrics on it) on synthetic traces: device time put down to the stage
whose mark precedes it, and idle stretches counted only under `blaze.*`
spans; every reader None on a trace with neither."""
from types import SimpleNamespace

import pytest

from zkbench import harness, marks, tracing


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def mark(stage, ts):
    return X("kernel", f"mark_{stage}_kernel(unsigned long long*)", ts, 1)


def trace(events, window=(0, 1000)):
    return tracing.Trace([X("user_annotation", tracing.WINDOW, window[0],
                            window[1] - window[0]), *events], {}, ("scan_mixed",))


def run(t, jobs=1):
    return SimpleNamespace(trace=t, records=[{}] * jobs, peaks=object())


# one MSM of two chunks: stream, then per chunk sort, layout, scan (K2),
# bucket, stream; then done and an operation after it that is no stage's
MSM = [mark("msm_stream", 0), X("kernel", "copy", 2, 10),
       mark("msm_sort", 20), X("kernel", "sort", 21, 30),
       mark("msm_layout", 60), X("kernel", "gather", 61, 100),
       mark("msm_scan", 170), X("kernel", "void scan_mixed_kernel<12>()", 171, 200),
       mark("msm_bucket", 380), X("kernel", "where", 381, 40),
       mark("msm_stream", 430), X("kernel", "clone", 431, 5),
       mark("msm_sort", 440), X("kernel", "sort", 441, 30),
       mark("msm_layout", 480), X("kernel", "gather", 481, 100),
       mark("msm_scan", 590), X("kernel", "void scan_mixed_kernel<12>()", 591, 200),
       mark("msm_bucket", 800), X("kernel", "where", 801, 40),
       mark("msm_stream", 850), X("kernel", "fold", 851, 20),
       mark("msm_done", 880), X("kernel", "gather", 890, 5)]


def test_device_time_goes_to_the_stage_of_the_mark_before_it():
    t = trace(list(reversed(MSM)))              # read in start order, whatever order stored
    assert marks.stage_s(t, "msm_sort") == pytest.approx(62e-6)
    assert marks.stage_s(t, "msm_layout") == pytest.approx(202e-6)
    assert marks.stage_s(t, "msm_scan") == pytest.approx(402e-6)
    assert marks.stage_s(t, "msm_bucket") == pytest.approx(82e-6)
    assert marks.stage_s(t, "msm_stream") == pytest.approx(38e-6)
    for stage, want in (("sort", 31), ("layout", 101), ("bucket", 41), ("stream", 19)):
        read = harness.reader(f"msm.{stage}_ms")
        assert read(run(t, jobs=2)) == pytest.approx(want * 1e-3)
    # the stages (K2 in msm_scan) cover every device operation but the
    # msm_done mark and the operation after it
    total = sum(marks.stage_s(t, s) for s in ("msm_sort", "msm_layout", "msm_scan",
                                              "msm_bucket", "msm_stream"))
    assert total == pytest.approx(sum(e["dur"] for e in MSM[:-2]) * 1e-6)


def test_stalls_count_only_under_program_spans():
    t = trace([X("kernel", "a", 0, 100), X("kernel", "b", 150, 50),
               X("kernel", "c", 300, 100), X("kernel", "d", 700, 300),
               X("user_annotation", "blaze.poseidon.start#4", 90, 80),   # gap 100-150
               X("user_annotation", "blaze.tree.root#4", 390, 10),      # not gap 400-700's middle
               X("cpu_op", "aten::copy_", 500, 100),                     # no program span
               X("user_annotation", "zkbench.job", 0, 1000)])
    assert marks.stall_s(t) == pytest.approx(50e-6)
    assert harness.reader("host_stall_ms.tree")(run(t, jobs=2)) == pytest.approx(0.025)
    assert marks.spans(t, "blaze.tree.root") == [(390, 400)]
    assert harness.reader("tree.root_ms")(run(t, jobs=2)) == pytest.approx(0.005)


def test_nothing_to_read_gives_none():
    t = trace([X("kernel", "void scan_mixed_kernel<12>()", 0, 100),
               X("user_annotation", "zkbench.job", 0, 1000)])
    names = ["msm.sort_ms", "msm.layout_ms", "msm.bucket_ms", "msm.stream_ms",
             "host_stall_ms.msm", "tree.root_ms"]
    for name in names:
        assert harness.reader(name)(run(t)) is None
        assert harness.reader(name)(SimpleNamespace(trace=t, records=[{}], peaks=None)) is None
    assert marks.stage_s(t, "msm_sort") is None and marks.stall_s(t) is None
