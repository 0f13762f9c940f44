"""E2: the Montgomery product's parts, each chained inside one launch.

The counterpart of experiments/redc_probe.py, whose pallas_call
(make_chain, :66) runs M dependent steps x <- body(x, b) of each body per
tile and takes the slope between M = 1 and 129.  Here the bodies are the
port's own (csrc/probe.cuh, csrc/mont_tc.cu), run by
csrc/probe_chain.cu's chain kernel, one lane per thread:

  mont      full product           K0's carry.cuh mont_mul_cc (canonical,
                                   64-bit C rows)
  conv      product convolution    mont_mul_cc's mul_row rows, no REDC
  ks_carry  one carry pass         x + b over the 2W limbs (add.cc chain)
  mm_i8     int8 m product         mont_tc.cu: x n' mod R on the tensor cores
  qmm_i8    int8 q product         mont_tc.cu: floor(x p / R)
  redc      REDC of x + b          mont_mul_cc's reduction rows
  add_f     field add              carry.cuh add_canon
  sub_f     field sub              carry.cuh sub_canon

and, beside K0's product (mont), the other forms of the same product
(csrc/probe.cuh), each equal to it word for word:

  mont_hi     lo / hi form   each word product an IMAD + IMAD.HI pair
                             (mad.lo.cc / madc.hi.cc), K0's form before
                             the IMAD.WIDE one
  mont_rz     wide, 2 chains each word product one IMAD.WIDE with no
                             addend, both halves added in two carry chains
  mont_comba  product scan   conv and REDC interleaved by column, a
                             three-word column accumulator
  mont_split  hi conv        mont_hi's conv rows, mont_wide's REDC rows
  mont_wide   wide, PTX      each word product a mad.wide.u32 with the
                             word as addend, the high halves in one
                             add.cc chain per row (PTX)
  mont_pair64 33-bit words   the accumulator's words kept as sums below
                             2^33, each word product a_j b_i + T_j

The forms of the product also run on one warp (32 lanes, bodies named
"<form> latency"), where a chain's step is one product's latency: the
time a kernel with few warps per SM (K4's rounds, K5, K6) pays per
product.

The cheap bodies (ks_carry, add_f, sub_f) take the slope between M = 1
and 4097: 128 of their steps cost less than the launch's memory traffic.

    python -m blaze_tpu_torch.experiments    (all five probes)
"""
from __future__ import annotations

from ..fields import FIELDS
from .chain import PRODUCT_BODIES, measure_chain

BODIES = (("mont", "mont"), ("conv", "conv"), ("ks_carry", "carry", "long"),
          ("mm_i8", "tc:mm"), ("qmm_i8", "tc:qmm"), ("redc", "redc"),
          ("add_f", "add_f", "long"), ("sub_f", "sub_f", "long"), ("mont_hi", "mont_hi"),
          ("mont_rz", "mont_rz"), ("mont_comba", "mont_comba"), ("mont_split", "mont_split"),
          ("mont_wide", "mont_wide"), ("mont_pair64", "mont_pair64"))
FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")     # W = 12 (the MSM's), W = 8
LONG_MS = (1, 4097)      # the cheap bodies' chains (chain.measure_chain)


LATENCY_LANES = 32       # one warp: a chain's step is one product's latency


def run(device="cuda", lanes: int = 1 << 20, ms: tuple = (1, 129), fields=FIELD_NAMES,
        reps: int = 3, check_lanes: int | None = 512, long_ms: tuple | None = LONG_MS) -> list:
    """One record per body and field (chain.measure_chain); the bodies
    marked long (a carry pass, an add, a sub) at `long_ms`.  Then each form
    of the product on one warp (LATENCY_LANES), named "<form> latency": a
    step there is one product's latency (step_ms)."""
    forms = [(f"{b} latency", b) for b in PRODUCT_BODIES]
    return [rec for f in fields
            for rec in (measure_chain("E2", FIELDS[f], BODIES, lanes, ms, device, reps=reps,
                                      check_lanes=check_lanes, long_ms=long_ms)
                        + measure_chain("E2", FIELDS[f], forms, LATENCY_LANES, ms,
                                        device, reps=reps, check_lanes=None))]
