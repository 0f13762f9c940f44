"""The MSM's precompute mode on the card at blaze's largest tested size,
BN254 at 2^26 bases, beside the plain MSM it replaces.

    python3 scripts/precompute_probe.py [--log-n 26] [--factor 8] [--msms 5]

(`--device cpu --log-n 8 --msms 1` rehearses it on the plain versions; the
K2 table then runs at 2^12-2^15 points on 512 lanes.)

0. K2 (`scan_gathered`) at the 8x mode's two windows on 16,384 lanes, at
   chunks of 2^19-2^22 points read through the sort of random 16-bit
   digits: ms a chunk (CUDA events), its work bound, and ns per
   window-point against the 2^19 chunk's (a larger chunk's points leave
   the L2).
1. The expansion: 2^log-n distinct bases (oracle.gen.distinct_resident_points)
   expanded by `precompute_resident` into their factor multiples; its
   seconds, the device memory it held at its peak beyond the bases and the
   residency it fills, and 4,096 sampled bases' multiples against
   `precompute_points`.
2. The MSMs, untraced: the precomputed MSM over 2^log-n tiled bases' 2^(log-n
   + 3) resident multiples and unsliced scalars, and the plain MSM of the
   same scalars over the 2^log-n bases, alternating, --msms of each; per
   MSM the host seconds, `MSM.stage_ms()` (device ms per stage from the
   stage marks; K2 is the scan stage) and the chunk plans it ran
   (`MSM.chunk_plans`: (windows, points, lanes) -> chunks), per chunk for
   K2; each result against the class sums.

Prints one JSON line per step.
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card(dev: str) -> str:
    if dev == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sync(dev: str) -> None:
    import torch

    if dev != "cpu":
        torch.cuda.synchronize()


def peak(dev: str) -> int:
    import torch

    return 0 if dev == "cpu" else torch.cuda.max_memory_allocated()


def k2_table(cv, spec, dev: str) -> list:
    import numpy as np
    import torch

    from blaze_tpu_torch.bench.profile import cuda_ms, speed_of_light, work_bound_ms
    from blaze_tpu_torch.curves.kernels import ECKernels
    from blaze_tpu_torch.msm import points_to_resident
    from blaze_tpu_torch.oracle import ECOracle
    from blaze_tpu_torch.oracle.gen import points_to_affine_words

    G, lanes, logs = (2, 1 << 14, range(19, 23)) if dev != "cpu" else (2, 512, range(12, 16))
    kern = ECKernels.for_curve(spec)
    rng = random.Random(4)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(256)]
    xy = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    unique = points_to_resident(cv, xy)
    sol = speed_of_light(torch.cuda.get_device_name() if dev != "cpu" else "cpu")
    g = torch.Generator(device=dev).manual_seed(5)
    rows, first = [], None
    for log in logs:
        N, R = 1 << log, lanes // G
        C = N // R
        pts = unique[:, torch.randint(0, 256, (N,), device=dev, generator=g)].contiguous()
        digits = torch.randint(0, 1 << 16, (G, N), device=dev, generator=g)
        order = torch.argsort(digits, dim=-1, stable=True)
        run = lambda: kern.scan_gathered(pts, order, R, C)         # noqa: E731
        if dev == "cpu":
            t = time.perf_counter()
            run()
            ms = (time.perf_counter() - t) * 1e3
        else:
            ms = cuda_ms(run, 5)
        ns = ms * 1e6 / (G * N)
        first = first or ns
        bound, by = work_bound_ms("scan_gathered", {"C": C, "B": G * R, "N": N, "G": G},
                                  cv.nwords, sol)
        rows.append({"step": "k2_table", "points": N, "windows": G, "lanes": G * R,
                     "steps": C, "ms": ms, "bound_ms": bound, "bound_by": by,
                     "ns_per_window_point": ns, "vs_first": ns / first})
        del pts, digits, order
    return rows


def expansion(cv, spec, log_n: int, factor: int, dev: str) -> dict:
    import torch

    from blaze_tpu_torch.msm import points_from_resident, points_to_resident
    from blaze_tpu_torch.msm import precompute_points, precompute_resident
    from blaze_tpu_torch.oracle.gen import distinct_resident_points

    n = 1 << log_n
    t = time.perf_counter()
    bases = distinct_resident_points(spec, n, 1, dev)
    sync(dev)
    made_s = time.perf_counter() - t
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() if dev != "cpu" else 0
    t = time.perf_counter()
    out = precompute_resident(cv, bases, factor)
    sync(dev)
    secs = time.perf_counter() - t
    transient = peak(dev) - before - out.numel() * 4
    idx = torch.randperm(n, device=dev)[:4096]
    want = points_to_resident(cv, precompute_points(cv, points_from_resident(
        cv, bases[:, idx].contiguous()), factor), mont=True)
    cols = (torch.arange(factor, device=dev)[:, None] * n + idx).reshape(-1)
    ok = torch.equal(out[:, cols], want)
    del out, bases
    if dev != "cpu":
        torch.cuda.empty_cache()
    return {"step": "expansion", "bases": n, "factor": factor, "bases_made_s": made_s,
            "expansion_s": secs, "residency_bytes": factor * n * 2 * cv.nwords * 4,
            "transient_peak_bytes": transient, "sampled_equal": ok}


def msms(cv, spec, log_n: int, factor: int, count: int, dev: str) -> list:
    import numpy as np
    import torch

    from blaze_tpu_torch.fields import words_to_int
    from blaze_tpu_torch.msm import MSM, points_to_resident, precompute_resident
    from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
    from blaze_tpu_torch.oracle.gen import points_to_affine_words

    n, U, W = 1 << log_n, 256, cv.nwords
    oracle = ECOracle(spec)
    rng = random.Random(2)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(U)]
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    res = points_to_resident(cv, pts)
    mult = precompute_resident(cv, res, factor)
    bases = mult.reshape(2 * W, factor, 1, U).expand(2 * W, factor, n // U, U).reshape(
        2 * W, factor * n)
    plain_res = res.repeat(1, n // U)
    del mult
    g = torch.Generator(device=dev).manual_seed(3)
    Ls = spec.fr.nlimbs
    low = torch.randint(0, 1 << 16, (Ls - 1, n), dtype=torch.int32, device=dev, generator=g)
    top = torch.randint(0, spec.fr.p >> (16 * (Ls - 1)), (1, n), dtype=torch.int32,
                        device=dev, generator=g)
    scalars = torch.cat([low, top])
    sums = scalars.reshape(Ls, n // U, U).to(torch.int64).sum(dim=1).cpu().numpy()
    want = class_sum_expected(spec, upoints, sums.T.astype(np.int64))
    engines = {"precomputed": MSM(cv), "plain": MSM(cv)}
    run = {"precomputed": lambda e: e.msm_precomputed(bases, scalars, factor),
           "plain": lambda e: e(plain_res, scalars)}
    out = []
    for name, e in engines.items():                       # warm: the captures
        got = run[name](e)
        sync(dev)
        X, Y, Z = (words_to_int(v) for v in got.cpu().numpy().view(np.uint32))
        zi = pow(Z, -1, spec.fq.p)
        out.append({"step": "check", "msm": name,
                    "correct": (X * zi % spec.fq.p, Y * zi % spec.fq.p) == want})
    times = {k: [] for k in engines}
    per_msm = {k: [] for k in engines}
    for _ in range(count):
        for name, e in engines.items():
            before, plans = e.stage_ms(), dict(e.chunk_plans)
            t = time.perf_counter()
            run[name](e)
            sync(dev)
            times[name].append(time.perf_counter() - t)
            after = e.stage_ms()
            per_msm[name].append({
                "stage_ms": {k: after[k] - before[k] for k in after if k != "calls"},
                "chunk_plans": {str(k): v - plans.get(k, 0)
                                for k, v in e.chunk_plans.items() if v != plans.get(k, 0)}})
    for name in engines:
        stages = {k: statistics.median(m["stage_ms"][k] for m in per_msm[name])
                  for k in per_msm[name][0]["stage_ms"]}
        chunks = sum(per_msm[name][0]["chunk_plans"].values())
        out.append({"step": "msm", "msm": name, "bases": n, "chunks": chunks,
                    "seconds": times[name], "median_s": statistics.median(times[name]),
                    "bases_per_s": n / statistics.median(times[name]),
                    "per_msm": per_msm[name], "stage_ms_median": stages,
                    "k2_ms_per_chunk": stages["scan"] / chunks,
                    "memory_peak_bytes": peak(dev)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=26)
    ap.add_argument("--factor", type=int, default=8)
    ap.add_argument("--msms", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from blaze_tpu_torch import _build
    from blaze_tpu_torch.curves import CURVES, Curve

    if args.device != "cpu":
        _build.build_all(("montmul", "field_ew", "ec_kernels", "trace_marks"))
    spec = CURVES["bn254"]
    cv = Curve(spec)
    print(json.dumps({"step": "card", "card": card(args.device)}), flush=True)
    for line in k2_table(cv, spec, args.device):
        print(json.dumps(line), flush=True)
    print(json.dumps(expansion(cv, spec, args.log_n, args.factor, args.device)), flush=True)
    for line in msms(cv, spec, args.log_n, args.factor, args.msms, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
