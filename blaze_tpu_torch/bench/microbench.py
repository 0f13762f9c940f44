"""Field-product microbenchmark: the port's two product designs on the
same operands.

    python -m blaze_tpu_torch.bench.microbench [field] [log2 batch]

The counterpart of blaze_tpu/bench/microbench.py, which times the JAX
package's one Montgomery product.  The port has two on the card:

  K1  fields/montmul.py mont_mul -> csrc/montmul.cu, on field.cuh's
      word-serial product, (n, W) words;
  K8  ntt/kernels.py mul_lm, two operands -> csrc/ntt_kernels.cu, on
      carry.cuh's carry chain, (n, W, 1) element rows (built at W = 8 and
      12, so every field here has it).

Each is timed through bench_kernel (CUDA events behind a spin of the
card) on the same canonical operands from a seed, with its ms, Mmul/s,
HBM and IMAD attainment and bound, and 4 products are held against
Python ints (a b R^-1 mod p) or the run fails.  One JSON line per kernel,
then the card's name and power limit.  Defaults: bls12_381_fq, 2^16.
Without a card it exits non-zero; `run(field, logb, "cpu")` times the
plain versions.
"""
from __future__ import annotations

import json
import sys

import torch

from ..fields import FIELDS, words_to_int
from ..fields.montmul import mont_mul
from ..ntt import NTTKernels
from ..oracle.gen import rand_words
from .profile import bench_kernel, kernel_work, smi

SPOT = 4


def run(field: str, logb: int, device, reps: int = 50) -> list:
    """One record per product kernel on 2^logb products of `field`."""
    spec = FIELDS[field]
    W, n = spec.nwords, 1 << logb
    a = rand_words(spec, (n, W), 1, device)
    b = rand_words(spec, (n, W), 2, device)
    k8 = NTTKernels.for_spec(spec)
    cases = [("mont_mul", lambda x, y: mont_mul(spec, x, y), (a, b), {"M": n}),
             ("mul_lm", k8.mul_lm, (a.view(n, W, 1), b.view(n, W, 1)),
              {"M": n, "N": 1, "operands": 2})]
    rinv = pow(1 << (32 * W), -1, spec.p)
    want = [words_to_int(a[i].cpu().numpy()) * words_to_int(b[i].cpu().numpy()) * rinv
            % spec.p for i in range(SPOT)]
    recs = []
    for name, fn, args, shape in cases:
        stats = bench_kernel(fn, args, name=f"{name}[{field}]", reps=reps,
                             work=kernel_work(name, shape, W))
        out = fn(*args).reshape(n, W)[:SPOT].cpu().numpy()
        got = [words_to_int(row) for row in out]
        recs.append({"kernel": name, "field": field, "batch": n, "ms": stats.best_s * 1e3,
                     "median_ms": stats.median_s * 1e3, "mmul_per_s": n / stats.best_s / 1e6,
                     "sol_fraction": stats.sol_fraction, "imad_fraction": stats.imad_fraction,
                     "bound_ms": stats.bound_ms, "bound_by": stats.bound_by,
                     "spot_check": got == want, "summary": stats.summary()})
    return recs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    field = argv[0] if argv else "bls12_381_fq"
    logb = int(argv[1]) if len(argv) > 1 else 16
    if not torch.cuda.is_available():
        print("microbench: no CUDA device", file=sys.stderr)
        return 1
    recs = run(field, logb, "cuda")
    for r in recs:
        print(json.dumps(r), flush=True)
    print(smi("name,power.limit"), flush=True)
    bad = [r["kernel"] for r in recs if r.get("spot_check") is False]
    if bad:
        print(f"microbench: {bad} differ from Python ints", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
