"""E3: the card's multiply forms and the product's convolutions, chained.

The counterpart of experiments/vpu_mul_probe.py (SUPERSEDED there; its
pallas_call make_chain, :81), which chains u32mul, mont_u32, conv_u32 and
conv_f32 per tile and takes the slope between M = 1 and 129.  On the H100
a 32 x 32-bit product issues as separate instructions for its halves, so
u32mul becomes one body per form (csrc/probe.cuh):

  u32mul.lo    mul.lo    (IMAD)       x <- lo(x b) + b per word
  u32mul.hi    mul.hi    (IMAD.HI)    x <- hi(x b) + b per word
  u32mul.wide  mul.wide  (IMAD.WIDE)  d <- lo(d) b + d per word pair
  mont_u32     the full product (mont)
  conv_u32     the product convolution (conv)
  conv_f32     the convolution as 8-bit digits in f32 FMAs (conv_f32)

The three multiply forms also run with S = 4 independent streams per
thread, which gives each thread 4W independent multiplies per step, and
take the slope between M = 1 and 4097: it is the issue rate of the form.
"""
from __future__ import annotations

from ..fields import FIELDS
from .chain import measure_chain

MUL_FORMS = (("u32mul.lo", "mul_lo", "long"), ("u32mul.hi", "mul_hi", "long"),
             ("u32mul.wide", "mul_wide", "long"))
BODIES = MUL_FORMS + (("mont_u32", "mont"), ("conv_u32", "conv"), ("conv_f32", "conv_f32"))
FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")
LONG_MS = (1, 4097)      # the multiply forms' chains (chain.measure_chain)


def run(device="cuda", lanes: int = 1 << 20, ms: tuple = (1, 129), fields=FIELD_NAMES,
        reps: int = 3, check_lanes: int | None = 512, long_ms: tuple | None = LONG_MS) -> list:
    """One record per body and field at S = 1, and the multiply forms at
    S = 4 (chain.measure_chain); the multiply forms at `long_ms`."""
    recs = []
    for f in fields:
        recs += measure_chain("E3", FIELDS[f], BODIES, lanes, ms, device, reps=reps,
                              check_lanes=check_lanes, long_ms=long_ms)
        recs += measure_chain("E3", FIELDS[f], MUL_FORMS, lanes, ms, device, S=4, reps=reps,
                              check_lanes=check_lanes, long_ms=long_ms)
    return recs
