#!/usr/bin/env python3
"""Find when torch.profiler loses the card's events, in one process.

    python3 scripts/profiler_probe.py [--wait-s S] [--waits N] [--lead-s L] [--plain]

Runs a sequence of short torch.profiler sessions (CPU + CUDA activities) on
one card, each around a 2^20 bls12_381_fr FusedNTT transform (K7 x3, K9 x2)
unless it says otherwise, in the order a full chip_smoke.py run meets their
suspects: three sessions in a row (a limit on sessions per process); one
on a side stream (the pipeline's NTT stream); one around 100,000 K1
launches (a full activity buffer), then a plain one after it; one after a
spin of the card and CUDA events (cuda_ms); one after an NTTClient round
trip (pinned staging, side-stream copies); one after an NCCL group of one
(make_mesh) ran a collective; one around a side-stream NTT beside 30,000
default-stream K1 launches (the pipeline's shape); then plain sessions
after waits of --wait-s seconds (process age).  With --plain it runs only
the plain sessions, one after each wait.  With --lead-s each
session's window opens L host seconds before its work starts and closes L
seconds after the work has finished.  During each wait the host's
wall clock (CLOCK_REALTIME, the clock the trace's timestamps are on) is
read against its monotonic clock every 10 ms: the line after the wait
gives how far their difference moved and its largest step.

For each session it prints one JSON line: the process age, the port's
launches in the session (the launch counters) against the kernel events
the profiler kept (key_averages), and from the exported Chrome trace the
least and the largest gap between a kernel's launch call and the kernel's
start (matched by correlation id; a negative gap means the device clock
runs behind the host clock), and the kernels that start before the
session's first host event or end after its last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("KINETO_LOG_LEVEL", "1")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def session(tag: str, fn, lead_s: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.trace import traced_launches

    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(lead_s)
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v > before[k]}
    traced = traced_launches((e.key, e.count) for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    x = [e for e in events if e.get("ph") == "X"]
    kernels = [e for e in x if e.get("cat") == "kernel"]
    host = [e for e in x if e.get("cat") in ("cpu_op", "cuda_runtime", "python_function",
                                               "user_annotation")]
    launch_ts = {e["args"].get("correlation"): e["ts"] for e in x
                 if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")}
    gaps = [k["ts"] - launch_ts[k["args"].get("correlation")] for k in kernels
            if k["args"].get("correlation") in launch_ts]
    first = min((e["ts"] for e in host), default=None)
    last = max((e["ts"] + e.get("dur", 0) for e in host), default=None)
    out = {"session": tag, "age_s": time.perf_counter() - T0, "lead_s": lead_s,
           "teardown_cupti": os.environ.get("TEARDOWN_CUPTI", "default"),
           "launched": launched,
           "traced": traced, "lost": {k: v - traced.get(k, 0) for k, v in launched.items()
                                      if traced.get(k, 0) < v},
           "trace_kernels": len(kernels), "matched": len(gaps),
           "launch_to_start_us": [min(gaps), max(gaps)] if gaps else None,
           "before_first_host_event": sum(k["ts"] < first for k in kernels) if first else None,
           "after_last_host_event": sum(k["ts"] + k.get("dur", 0) > last for k in kernels)
           if last else None}
    emit(out)
    return out


def clock_offsets(seconds: float) -> dict:
    """CLOCK_REALTIME minus CLOCK_MONOTONIC (ms), read every 10 ms for
    `seconds`: its range, and the largest change between two reads."""
    offs = []
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        offs.append((time.time_ns() - time.monotonic_ns()) / 1e6)
        time.sleep(0.01)
    steps = [abs(b - a) for a, b in zip(offs, offs[1:])]
    return {"realtime_minus_monotonic_ms": [offs[0], offs[-1]],
            "moved_ms": max(offs) - min(offs), "largest_step_ms": max(steps, default=0.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wait-s", type=float, default=30.0)
    ap.add_argument("--waits", type=int, default=4)
    ap.add_argument("--lead-s", type=float, default=0.0)
    ap.add_argument("--plain", action="store_true",
                    help="only plain sessions, one after each wait: process age alone")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    from blaze_tpu_torch import _build
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.fields.montmul import mont_mul
    from blaze_tpu_torch.ntt import FusedNTT
    from blaze_tpu_torch.runtime import NTTClient, NTTInit, NTTInput

    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": _build.build_all(("montmul", "ntt_kernels"))})
    dev = torch.device("cuda", 0)
    spec = FIELDS["bls12_381_fr"]
    plan = FusedNTT(spec, 20, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 1 << 30, (plan.n, 8), generator=g, dtype=torch.int32, device=dev)
    a = x[:1024].contiguous()
    plan.ntt(x)
    mont_mul(spec, a, a)
    side = torch.cuda.Stream(dev)

    def on_side():
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            plan.ntt(x)

    ntt = lambda: plan.ntt(x)                                     # noqa: E731

    def run(tag, fn):
        return session(tag, fn, args.lead_s)

    if args.plain:
        for i in range(args.waits):
            emit({"wait": i + 1, **clock_offsets(args.wait_s)})
            run(f"ntt_after_wait_{i + 1}", ntt)
        return 0
    for i in range(3):
        run(f"ntt_{i + 1}", ntt)
    run("ntt_side_stream", on_side)
    run("k1_x100000", lambda: [mont_mul(spec, a, a) for _ in range(100_000)])
    run("ntt_after_many", ntt)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(3):
        plan.ntt(x)
    end.record()
    torch.cuda.synchronize()
    run("ntt_after_spin", ntt)
    cl = NTTClient(NTTInit(field=spec.name, logn=20))
    host = np.zeros((plan.n, 8), dtype=np.uint32)
    cl.set_data(NTTInput(data=memoryview(host).cast("B"), buf_host=0))
    cl.start_process(0)
    cl.wait_result(0)
    cl.result(0)
    run("ntt_after_client", ntt)
    import torch.distributed as dist

    from blaze_tpu_torch.dist import make_mesh
    from blaze_tpu_torch.dist.mesh import all_gather, mesh_axis

    try:
        mesh = make_mesh({"dp": 1}, device_type="cuda")
        group, size, _ = mesh_axis(mesh, "dp")
        all_gather(torch.ones(4, device=dev), group, size)
        torch.cuda.synchronize()
        run("ntt_after_nccl", ntt)
    finally:
        dist.destroy_process_group()
    run("side_ntt_beside_k1_x30000",
        lambda: (on_side(), [mont_mul(spec, a, a) for _ in range(30_000)]))
    for i in range(args.waits):
        emit({"wait": i + 1, **clock_offsets(args.wait_s)})
        run(f"ntt_after_wait_{i + 1}", ntt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
