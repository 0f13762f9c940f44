#!/usr/bin/env python3
"""Where the host's time goes in one resident BLS12-381 MSM on the card.

    python3 scripts/msm_host_profile.py [--logn 24] [--top 12]

Builds the kernels, makes 2^logn resident points (256 order-r subgroup
points tiled, as the smoke's pipeline phase does) and scalars (random
canonical values below 2^254, cut into 16-bit limbs on the card), and
times with a host clock (synchronised), three times each and in turns:
the MSM on those scalars; the MSM on the scalars of a proof pipeline's
batch (ProofPipeline at (logn + 3, logn), e_1: scalars W^i); and that
batch through run_batches.  Then one more MSM under cProfile.  Prints one
JSON line with the walls and the functions with the most own time
(calls, own seconds, cumulative seconds), then the card's name and power
limit.  The 2^24 MSM is host-bound (PERF.md §5): this says which
Python-level work holds the card back, and whether the pipeline adds to
it.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--logn", type=int, default=24)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("msm_host_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from blaze_tpu_torch import _build
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.msm import points_to_resident
    from blaze_tpu_torch.oracle import ECOracle
    from blaze_tpu_torch.oracle.gen import points_to_affine_words
    from blaze_tpu_torch.pipeline import ProofPipeline

    _build.build_all(("montmul", "ec_kernels", "ntt_kernels"))

    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 << args.logn
    rng = random.Random(0)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(256)]
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    points = points_to_resident(cv, pts).repeat(1, n // 256)
    words = cs.rand_words(spec.fr, (n, spec.fr.nwords), 1, dev)
    scalars = (words.view(torch.int16).t().to(torch.int32) & 0xFFFF).contiguous()
    del words
    pipe = ProofPipeline(cv, args.logn + 3, args.logn)
    msm = pipe.msm
    e1 = torch.zeros((pipe.plan.n, spec.fr.nwords), dtype=torch.int32, device=dev)
    e1[1, 0] = 1
    powers = pipe.scalars(e1)
    runs = {"msm_random_scalars": lambda: msm(points, scalars),
            "msm_pipeline_scalars": lambda: msm(points, powers),
            "run_batches_e1": lambda: list(pipe.run_batches([e1], points))}
    walls = {k: [] for k in runs}
    for _ in range(3):
        for key, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    msm(points, scalars)
    torch.cuda.synchronize()
    prof.disable()
    profiled = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:args.top]
    print(json.dumps({
        "n": n, "walls_s": walls, "profiled_s": profiled,
        "top_own_time": [{"function": f"{Path(f).name}:{line}({name})", "calls": v[1],
                          "own_s": v[2], "cumulative_s": v[3]}
                         for (f, line, name), v in top]}), flush=True)
    print(cs.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
