#!/usr/bin/env python3
"""Time every kernel of the port at its main shape from two or more trees of
the package on one card, in turns: a same-card comparison of kernels.

    python3 scripts/kernel_ab.py TREE [TREE ...] [--rounds N] [--only ec,ntt8,ntt12,poseidon]

Round r runs one fresh child process per tree, the trees in the given
order in even rounds and reversed in odd ones (A B, B A, A B, ...).  Each
child imports blaze_tpu_torch and chip_smoke from its own tree (and refuses
a package imported from elsewhere), builds that tree's kernels, and times
with that tree's bench.profile.cuda_ms (CUDA events behind a spin of the
card):
  ec        K1 and K2-K6 at the 2^19 chunk's shapes on BLS12-381
            (chip_smoke.kernel_cases, main=True; no plain version runs),
            K2 in both forms: rows (scan_mixed) and read through 16
            windows' sort of 2^19 points (scan_gathered), and K4's first
            pass in both forms: on the bucket rows made (reduce_cols) and
            reading the same operands in place through the bounds
            (reduce_buckets), so one tree compares them;
  ntt8      K7 at each level and K9 at each depth of the 2^27 plan on
            bls12_381_fr, K8 at the 2^16 plan's call (chip_smoke
            ntt_main_timing, whose plain versions run on a cut);
  ntt12     the same on bls12_377_fq (W = 12);
  poseidon  K10 at the leaf sponge (t = 12, 2^24 states) and the first node
            level (t = 9, 2^21) (chip_smoke.poseidon_main_timing).
Every kernel's output is held against its plain version where those
functions do (a cut), and the child fails on any difference.  Prints one
JSON line per child ({"tree", "round", "ms": {key: ms}}), then one line per
key with each tree's median and the ratio of each tree's median to the
first tree's (a key only some trees time: theirs), then the card's name
and power limit.  Exits non-zero
without a card or when a child fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SECTIONS = ("ec", "ntt8", "ntt12", "poseidon")
CHILD_TIMEOUT_S = 900


def child(tree: Path, sections: list) -> dict:
    """The kernels' times from `tree`'s package: {key: ms}."""
    sys.path.insert(0, str(tree))
    import torch

    import blaze_tpu_torch
    import chip_smoke as cs

    if Path(blaze_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"blaze_tpu_torch imported from {blaze_tpu_torch.__file__}, "
                         f"not from {tree}")
    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import cuda_ms, device_kind, speed_of_light
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT

    dev = torch.device("cuda")
    sol = speed_of_light(device_kind(dev))
    _build.build_all()
    out = {}
    if "ec" in sections:
        for key, _, kern, _, shape in cs.kernel_cases(CURVES["bls12_381"], 512, 16384, 2, dev,
                                                       main=True):
            out[key] = cuda_ms(kern, 3 if shape.get("C", 0) >= 256 else 20)
        torch.cuda.empty_cache()
    for sec, field in (("ntt8", "bls12_381_fr"), ("ntt12", "bls12_377_fq")):
        if sec in sections:
            timing = cs.ntt_main_timing(FusedNTT(FIELDS[field], 27, device=dev), sol, 0, dev)
            bad = {k: v["max_abs_err"] for k, v in timing.items() if v["max_abs_err"]}
            if bad:
                raise AssertionError(f"{field}: kernels differ from their plain versions: {bad}")
            out.update({k: v["ms"] for k, v in timing.items()})
            torch.cuda.empty_cache()
    if "poseidon" in sections:
        timing = cs.poseidon_main_timing(sol, 0, dev)
        if any(v["max_abs_err"] for v in timing.values()):
            raise AssertionError("K10 differs from its plain version")
        out.update({k: v["ms"] for k, v in timing.items()})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--only", default=",".join(SECTIONS))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.trees = [t.resolve() for t in args.trees]
    sections = args.only.split(",")
    if args.child:
        print(json.dumps(child(args.trees[0], sections)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {str(t): [] for t in args.trees}
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            proc = subprocess.run([sys.executable, __file__, str(tree), "--child", "--only",
                                   args.only], cwd=tree, env=env, capture_output=True,
                                  text=True, timeout=CHILD_TIMEOUT_S)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            ms = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[str(tree)].append(ms)
            print(json.dumps({"tree": str(tree), "round": r, "ms": ms}), flush=True)
    first = str(args.trees[0])
    for key in dict.fromkeys(k for ms in runs.values() for k in ms[0]):
        med = {t: statistics.median(m[key] for m in ms) for t, ms in runs.items()
               if key in ms[0]}
        vs = {t: v / med[first] for t, v in med.items()} if first in med else None
        print(json.dumps({"key": key, "median_ms": med, "vs_first": vs}), flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from blaze_tpu_torch.bench.profile import smi

    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
