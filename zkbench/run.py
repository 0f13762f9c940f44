"""Run one cell of the benchmark once, on the card this process sees.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (builds or loads the program's kernels, makes the inputs from the
seed, warms up), then measures for --seconds (--trace 0: the cell's
end-to-end metrics) or traces a short stretch of jobs (--trace 1: its
per-layer metrics), judges the outputs against the plain reference under
zkbench/reference/, and prints one JSON line as its last line of output.
The numbers compared, each beside its limit, are the last lines on
standard error and the result's last key.  Exits 2 without a result where
no card, or fewer cards than the cell asks for, is present; 3 where a
module of JAX or of the JAX package was loaded; 1 on any other failure.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blaze_tpu")
# On the card's machine torch.profiler loses device events in a process
# older than about 40 s: a traced run whose set-up began with a build of
# this many seconds starts afresh, with the build in place.
FRESH_AFTER_BUILD_S = 5.0
FRESH_MARK = "ZKBENCH_TRACE_AFTER_BUILD"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "zkbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p and str(Path(p).resolve()) != here]
    from zkbench import harness

    cell = harness.resolve(args.workload)
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch import _build

    where = Path(blaze_tpu_torch.__file__).resolve().parent.parent
    if where != ROOT:
        print(f"zkbench: the program was imported from {where}, not this checkout",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zkbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    built_s = _build.build_all(cell.loop.Loop.libs)
    if args.trace and built_s > FRESH_AFTER_BUILD_S and not os.environ.get(FRESH_MARK):
        os.environ[FRESH_MARK] = "1"
        sys.stdout.flush()
        os.execv(sys.executable, [sys.executable, *sys.argv])
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                T_START)
    bad = forbidden_modules()
    if bad:
        print(f"zkbench: the run loaded {bad}: the benchmark runs the PyTorch port only",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
