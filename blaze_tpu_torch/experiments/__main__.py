"""python -m blaze_tpu_torch.experiments [--cut] [--only E1,...] [--lanes N] [--device cpu]

Runs the five probes (E1-E5) on the card at their full sizes (--cut: the
smoke's 2^16 lanes; --lanes N every lane count N): one JSON line per body, then the card's name and
power limit (nvidia-smi), then one line with K2's body split from E5.
Exits non-zero without a card (unless --device cpu: the plain versions,
nothing timed) or when a kernel differs from its plain version.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import failures, run_all
from .kernel_variants import shares


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cut", action="store_true", help="the smoke's cut sizes")
    ap.add_argument("--only", default=None, help="comma-separated probes, e.g. E1,E2")
    ap.add_argument("--lanes", type=int, default=None, help="every probe's lane count")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("experiments: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    recs = run_all(args.device, cut=args.cut,
                   only=None if args.only is None else args.only.split(","), lanes=args.lanes)
    for r in recs:
        print(json.dumps(r), flush=True)
    if args.device == "cuda":
        from ..bench.profile import smi

        print(smi("name,power.limit"), flush=True)
    else:
        print("cpu", flush=True)
    print(json.dumps({"e5_shares": shares(recs)}), flush=True)
    bad = failures(recs)
    if bad:
        print(f"experiments: {[(r['probe'], r['body'], r['field']) for r in bad]} differ "
              "from their plain versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
