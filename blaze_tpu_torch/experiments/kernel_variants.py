"""E5: one launch of each of the MSM kernel's body variants.

The counterpart of experiments/kernel_variants.py (SUPERSEDED there; its
pallas_call make(body_fn, n_in), :46), which times one product, 11
independent products (XOR-combined), 11 chained, 8 adds and 7 subs, and
the whole mixed-add body of blaze_tpu/curves/kernels.py:143
_add_mixed_body, each in one launch over 512 x 256 lanes of BLS12-381's
Fq.  Here:

  mul x1           csrc/probe.cuh kMont, M = 1
  mul x11 indep    kMont11 (11 independent products, XOR-combined), M = 1
  mul x11 chained  kMont, M = 11
  addf/subf x15    kGlue15 (8 add_canon, 7 sub_canon), M = 1
  mixed-add body   RCB alg 8 on ec_team.cuh's team of six, as K2 runs it
                   (probe_chain.cu probe_chain_mixed_kernel), M = 1

Each record gives the launch's time and its element operations per second
(products, adds or group ops).
"""
from __future__ import annotations

import torch

from ..curves import CURVES
from .chain import (
    BODIES,
    max_err,
    plain_timed,
    probe_chain,
    probe_chain_plain,
    probe_mixed,
    probe_mixed_plain,
    rates,
    registers,
    step_ops,
    timed_ms,
)

# (name, port body, M, element operations per lane)
VARIANTS = (("mul x1", "mont", 1, 1), ("mul x11 indep", "mont11", 1, 11),
            ("mul x11 chained", "mont", 11, 11), ("addf/subf x15", "glue15", 1, 15),
            ("mixed-add body", "mixed", 1, 1))


def run(device="cuda", lanes: int = 512 * 256, curve: str = "bls12_381", reps: int = 10,
        check_lanes: int | None = 512) -> list:
    """One record per variant on `lanes` lanes of canonical operands."""
    from ..bench.profile import device_kind, speed_of_light
    from ..oracle.gen import rand_words

    cs = CURVES[curve]
    spec = cs.fq
    W = spec.nwords
    dev = torch.device(device)
    sol = speed_of_light(device_kind(dev))
    x, b = rand_words(spec, (lanes, W), 3, dev), rand_words(spec, (lanes, W), 4, dev)
    p = rand_words(spec, (3, W, lanes), 5, dev).reshape(3 * W, lanes)
    q = rand_words(spec, (2, W, lanes), 6, dev).reshape(2 * W, lanes)
    k = lanes if check_lanes is None else min(check_lanes, lanes)
    recs = []
    for name, body, M, units in VARIANTS:
        if body == "mixed":
            def fn():
                return probe_mixed(cs, p, q, M)

            got = fn()[:, :k]
            want, plain_ms = plain_timed(
                lambda: probe_mixed_plain(cs, p[:, :k].contiguous(), q[:, :k].contiguous(), M),
                dev)
            key = ("probe_chain_mixed", W)
        else:
            def fn(body=body, M=M):
                return probe_chain(spec, body, x, b, M)

            got = fn()[:k]
            want, plain_ms = plain_timed(
                lambda body=body, M=M: probe_chain_plain(spec, body, x[:k], b[:k], M), dev)
            key = ("probe_chain", W, BODIES.index(body), 1)
        ms = timed_ms(fn, dev, reps)
        ops = step_ops(key) if dev.type == "cuda" else None
        recs.append({"probe": "E5", "body": name, "port_body": body, "field": spec.name,
                     "W": W, "lanes": lanes, "M": M, "ms": ms,
                     "units_per_lane": units,
                     **rates(ms, units * lanes, None, 1, 32, sol),
                     "sass": ops, "registers": registers(key), "checked_lanes": k,
                     "plain_ms": plain_ms,
                     "max_abs_err": max_err(got, want)})
    return recs


def shares(recs: list) -> dict | None:
    """K2's body split from E5's records: the mixed-add body's time against
    its 13 products at the chained-product rate (the 11 independent
    products' unrolled body outgrows the instruction cache, PERF.md §6) and
    its 13 adds and subs at the glue rate (each scaled from the x11 and x15
    launches).  None unless all three were timed."""
    by = {r["body"]: r["ms"] for r in recs if r.get("probe") == "E5"}
    if any(by.get(n) is None for n in ("mixed-add body", "mul x11 chained", "addf/subf x15")):
        return None
    body = by["mixed-add body"]
    products = by["mul x11 chained"] * 13 / 11
    glue = by["addf/subf x15"] * 13 / 15
    return {"mixed_add_ms": body, "products_ms": products, "glue_ms": glue,
            "products_share": products / body, "glue_share": glue / body,
            "rest_share": 1 - (products + glue) / body}
