"""What the program's spans and stage marks read on the card, per benchmark
cell, in one process: the cell's set-up as the benchmark makes it, a traced
window of the cell's traced jobs (torch.profiler, early in the process: the
profiler loses the card's events in a process older than ~40 s), then an
untraced window of --seconds.

    python3 scripts/trace_report.py --workload <cell> [--seed N] [--seconds 30]

Prints one JSON line: the cell's per-layer metrics as the benchmark's
readers give them; device busy ms per job; for an MSM cell the stages'
device ms (each split into the program's kernels and torch's glue, with
its costliest operations) and K2's, their sum against busy, the marks'
count and device us per job, and `MSM.stage_ms()` per MSM over the
untraced window; the device idle time inside the jobs, the share of it
under `blaze.*` spans, and where the rest lies (before or after the
program's spans in a job; in stretches under 20 us or longer); the
`blaze.msm.capture` spans in the traced window (0: no capture in steady
state); and the median job latency traced and untraced (tracing's cost).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def overlap(xs: list, ys: list) -> list:
    """The intersection of two sorted lists of disjoint [a, b) intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(xs: list) -> float:
    return sum(b - a for a, b in xs)


def stage_split(tr, inside: list, jobs: int) -> tuple:
    """Per MSM stage (the last mark's), device ms in the program's kernels
    and in the rest (torch's glue), and the stage's three costliest
    operations, of the window's device operations `inside`."""
    from zkbench import marks

    split, ops, stage = {}, {}, None
    for name, _, dur in sorted(inside, key=lambda e: e[1]):
        m = marks.MARK.search(name)
        stage = m[1] if m else stage
        part = split.setdefault(str(stage), {"kernels": 0.0, "glue": 0.0})
        part["kernels" if tr.is_kernel(name) else "glue"] += dur / 1e3 / jobs
        ops[str(stage), name[:50]] = ops.get((str(stage), name[:50]), 0.0) + dur / 1e3 / jobs
    top = {s: sorted(([n, v] for (t, n), v in ops.items() if t == s), key=lambda x: -x[1])[:3]
           for s in split}
    return split, top


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def report(name: str, seed: int, seconds: float, device: str = "cuda", cell=None) -> dict:
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.trace import MSM_STAGES
    from zkbench import harness, marks, tracing, work

    cell = cell or harness.resolve(name)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        _build.build_all((*cell.loop.Loop.libs, "trace_marks"))
    job = cell.loop.Loop(cell.config, cell.traffic, seed, torch.device(device))
    t0 = time.perf_counter()
    job.setup()
    setup_s = time.perf_counter() - t0
    msm = getattr(job, "msm", None)

    count = int(cell.traffic["traced_jobs"])
    records, tr = tracing.profile(lambda: job.window(lambda j, _: j >= count),
                                  _build.LAUNCHES, on_card)
    peaks = work.peaks_for(torch.cuda.get_device_name()) if on_card else None
    run = harness.Run(cell, job, records, tr, peaks)
    jobs = len(records)
    out = {"cell": name, "seed": seed, "card": card() if on_card else "cpu",
           "setup_s": setup_s, "traced_jobs": jobs,
           "metrics": {m["name"]: harness.reader(m["name"])(run) for m in cell.per_layer},
           "busy_ms_per_job": 1e3 * tr.busy_s / jobs}

    lo, hi = tr.window
    inside = [(n, ts, d) for n, ts, d in tr.device if lo <= ts < hi]
    mark_ops = [d for n, _, d in inside if marks.MARK.search(n)]
    out["marks_per_job"] = len(mark_ops) / jobs
    out["marks_device_us_per_job"] = sum(mark_ops) / jobs
    if mark_ops:
        stages = {s: 1e3 * marks.stage_s(tr, s) / jobs for s in MSM_STAGES}
        k2 = sum(d for n, _, d in inside if "scan_mixed_kernel" in n) / 1e3 / jobs
        out["stage_device_ms_per_msm"] = stages
        out["k2_ms_per_msm"] = k2
        out["stage_split_ms_per_msm"], out["stage_top_ops"] = stage_split(tr, inside, jobs)
        four = sum(v for s, v in stages.items() if s != "msm_scan")
        out["four_stages_plus_k2_over_busy"] = (four + k2) / out["busy_ms_per_job"]

    edges = [lo] + [x for span in tr.busy() for x in span] + [hi]
    gaps = [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]
    in_jobs = overlap(gaps, tracing.union(tr.jobs))
    under = overlap(in_jobs, tracing.union(marks.spans(tr)))
    out["idle_in_jobs_ms_per_job"] = length(in_jobs) / 1e3 / jobs
    out["idle_in_jobs_under_blaze_share"] = length(under) / length(in_jobs) if in_jobs else None
    # each job split at its program's extent (its first program span's
    # start to its last one's end): idle before it (the harness's call),
    # inside it, and after it (the harness's synchronize returning)
    ext = []
    for ja, jb in tr.jobs:
        own = [s for s in marks.spans(tr) if ja <= s[0] < jb]
        if own:
            ext.append([min(a for a, _ in own), max(b for _, b in own)])
    in_ext = overlap(in_jobs, tracing.union(ext))
    out["idle_in_jobs_before_after_program_ms_per_job"] = (
        length(in_jobs) - length(in_ext)) / 1e3 / jobs
    out["idle_in_program_ms_per_job"] = length(in_ext) / 1e3 / jobs
    out["idle_in_program_under_blaze_share"] = (
        length(overlap(in_ext, under)) / length(in_ext) if in_ext else None)
    # idle in jobs outside every program span, in stretches under 20 us
    # (the device's own gaps between queued operations, while the host
    # waits) and longer ones
    rest = [length([[a, b]]) - length(overlap([[a, b]], under)) for a, b in in_jobs]
    out["idle_in_jobs_outside_spans_ms_per_job"] = {
        "under_20us": sum(r for r, (a, b) in zip(rest, in_jobs) if b - a < 20) / 1e3 / jobs,
        "longer": sum(r for r, (a, b) in zip(rest, in_jobs) if b - a >= 20) / 1e3 / jobs}
    # the longest idle stretches in jobs outside every program span: the
    # innermost host event around each one's middle, and where it lies in
    # its job (ms after the job's start, ms before its end)
    outside = []
    for (a, b), r in zip(in_jobs, rest):
        if r > 0:
            mid = (a + b) / 2
            around = [(d, n) for n, ts, d in tr.host if ts <= mid <= ts + d]
            ja, jb = next(j for j in tr.jobs if j[0] <= mid <= j[1])
            outside.append([(b - a) / 1e3, min(around)[1][:60] if around else "untraced",
                            (a - ja) / 1e3, (jb - b) / 1e3])
    out["idle_in_jobs_outside_spans_top"] = sorted(outside, key=lambda g: -g[0])[:8]
    out["captures_in_window"] = len(marks.spans(tr, "blaze.msm.capture"))
    lat = [1e3 * (r["done"] - r["submit"]) for r in records]
    out["traced_latency_ms"] = {"median": statistics.median(lat), "all": lat}

    before = msm.stage_ms() if msm is not None else None
    recs = job.window(lambda j, el: j >= job.sets and el >= seconds)
    lat = [1e3 * (r["done"] - r["submit"]) for r in recs]
    out["untraced_latency_ms"] = {"median": statistics.median(lat), "jobs": len(lat),
                                  "min": min(lat), "max": max(lat)}
    out["tracing_cost_pct"] = 100 * (out["traced_latency_ms"]["median"]
                                     / out["untraced_latency_ms"]["median"] - 1)
    if before is not None and on_card:
        after = msm.stage_ms()
        calls = after["calls"] - before["calls"]
        out["stage_ms_per_msm_untraced"] = {k: (after[k] - before[k]) / calls
                                            for k in after if k != "calls"}
        out["stage_ms_calls"] = calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1234567891011)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    print(json.dumps(report(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
