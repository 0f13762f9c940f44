"""E2: the Montgomery product's parts, each chained inside one launch.

The counterpart of experiments/redc_probe.py, whose pallas_call
(make_chain, :66) runs M dependent steps x <- body(x, b) of each body per
tile and takes the slope between M = 1 and 129.  Here the bodies are the
port's own (csrc/probe.cuh, csrc/mont_tc.cu), run by
csrc/probe_chain.cu's chain kernel, one lane per thread:

  mont      full product           carry.cuh mont_mul_cc (canonical)
  conv      product convolution    mont_mul_cc's mul_word_acc rows, no REDC
  ks_carry  one carry pass         x + b over the 2W limbs (add.cc chain)
  mm_i8     int8 m product         mont_tc.cu: x n' mod R on the tensor cores
  qmm_i8    int8 q product         mont_tc.cu: floor(x p / R)
  redc      REDC of x + b          mont_mul_cc's reduction rows
  add_f     field add              carry.cuh add_canon
  sub_f     field sub              carry.cuh sub_canon

The cheap bodies (ks_carry, add_f, sub_f) take the slope between M = 1
and 4097: 128 of their steps cost less than the launch's memory traffic.

    python -m blaze_tpu_torch.experiments    (all five probes)
"""
from __future__ import annotations

from ..fields import FIELDS
from .chain import measure_chain

BODIES = (("mont", "mont"), ("conv", "conv"), ("ks_carry", "carry", "long"),
          ("mm_i8", "tc:mm"), ("qmm_i8", "tc:qmm"), ("redc", "redc"),
          ("add_f", "add_f", "long"), ("sub_f", "sub_f", "long"))
FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")     # W = 12 (the MSM's), W = 8
LONG_MS = (1, 4097)      # the cheap bodies' chains (chain.measure_chain)


def run(device="cuda", lanes: int = 1 << 20, ms: tuple = (1, 129), fields=FIELD_NAMES,
        reps: int = 3, check_lanes: int | None = 512, long_ms: tuple | None = LONG_MS) -> list:
    """One record per body and field (chain.measure_chain); the bodies
    marked long (a carry pass, an add, a sub) at `long_ms`."""
    return [rec for f in fields
            for rec in measure_chain("E2", FIELDS[f], BODIES, lanes, ms, device, reps=reps,
                                     check_lanes=check_lanes, long_ms=long_ms)]
