"""E4: the product's parts as independent streams (throughput, not latency).

The counterpart of experiments/mul_kernel_bench.py (SUPERSEDED there; its
pallas_call make_fn, :83), which runs S = 4 independent streams x R
repetitions of full / conv / redc / addf and takes the slope between R and
R/2.  Here each thread runs S = 4 streams of one lane's element through
csrc/probe_chain.cu's chain kernel (the S = 4 builds), so the card holds
four independent chains per thread where E2 holds one: E2 against E4 says
whether a body's time is latency or issue.  addf runs R = 2048 and 4096:
fewer of its steps hide under the launch's memory traffic.

  full  mont     conv  conv     redc  redc     addf  add_f
"""
from __future__ import annotations

from ..fields import FIELDS
from .chain import measure_chain

BODIES = (("full", "mont"), ("conv", "conv"), ("redc", "redc"), ("addf", "add_f", "long"))
FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")
STREAMS = 4
LONG_R = (2048, 4096)    # addf's repetitions (chain.measure_chain)


def run(device="cuda", lanes: int = 1 << 20, reps_r: tuple = (4, 8), fields=FIELD_NAMES,
        reps: int = 3, check_lanes: int | None = 512, long_ms: tuple | None = LONG_R) -> list:
    """One record per body and field, S = 4 (chain.measure_chain); addf at
    `long_ms` repetitions."""
    return [rec for f in fields
            for rec in measure_chain("E4", FIELDS[f], BODIES, lanes, reps_r, device, S=STREAMS,
                                     reps=reps, check_lanes=check_lanes, long_ms=long_ms)]
