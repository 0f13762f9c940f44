"""Run a cell with the control or a planted fault in the program's place,
on the card at the cell's own size, and print what the comparison read.

    python3 zkbench/control.py --workload <cell> --seeds 11,12,13 [--seconds 3]
                               [--fault control|unchanged|half|altered]

Each seed is one run of the cell (set-up, a window of --seconds, the
comparison) in this process, with the control (default) or a fault of
the cell's job loop (zkbench/loops/<job>.py) planted under the timed
path.  One JSON line per seed: the seed,
`correct` and every number compared with its limit.  Exits 0 when every
run came out not correct, as a control must, and 1 otherwise.  The
benchmark's own runs never plant anything.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="control")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p and str(Path(p).resolve()) != here]
    import torch

    from zkbench import harness

    cell = harness.resolve(args.workload)
    plant = cell.loop.control if args.fault == "control" else cell.loop.FAULTS[args.fault]
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run(cell, seed, args.seconds, False, "cuda",
                                time.perf_counter(), fault=plant)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "checks": result["checks"]}),
              flush=True)
        caught = caught and not result["correct"]
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
