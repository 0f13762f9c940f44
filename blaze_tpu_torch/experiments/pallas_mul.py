"""E1: the Montgomery product with its REDC on the int8 tensor cores.

The counterpart of experiments/pallas_mul.py, whose PallasMont.mul
(pallas_call at :146, body _kernel :77) runs the limb convolution on the
TPU's VPU and the REDC as two bf16 matrix products of byte-split operands
on its matrix unit.  Its counterpart is experiments/chain.py mont_tc
(mode "mont") on csrc/mont_tc.cu: the convolution on IMAD and the REDC's
two products (m = t n' mod R, q = m p) as mma.sync u8 products of
constant byte Toeplitz matrices with the elements' bytes.

`run` makes PallasMont.main's two measurements on the card: one product
beside K1 (fields/montmul.py mont_mul, whose words it must equal) at K1's
table shape, and M = 8 dependent products in one launch beside E2's mont
body (carry.cuh mont_mul_cc) at the same M, whose words it must equal.
"""
from __future__ import annotations

import torch

from ..fields import FIELDS
from ..fields.montmul import mont_mul
from .chain import (
    TC_MODES,
    max_err,
    mont_tc,
    mont_tc_plain,
    plain_timed,
    probe_chain,
    rates,
    registers,
    step_ops,
    tc_work,
    timed_ms,
    work_bound,
)

FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")


def run(device="cuda", one_lanes: int = 1 << 19, chain_lanes: int = 1 << 20, chain: int = 8,
        fields=FIELD_NAMES, reps: int = 10, check_lanes: int | None = 512) -> list:
    """Two records per field: one product at `one_lanes` (with K1's time on
    the same operands, and their words equal), and `chain` dependent
    products at `chain_lanes` (with E2's mont body at the same M, and their
    words equal); each also held against the plain version on the first
    `check_lanes` lanes."""
    from ..bench.profile import device_kind, speed_of_light
    from ..oracle.gen import rand_words

    dev = torch.device(device)
    sol = speed_of_light(device_kind(dev))
    recs = []
    for f in fields:
        spec = FIELDS[f]
        W = spec.nwords
        key = ("mont_tc", W, TC_MODES.index("mont"))
        ops = step_ops(key) if dev.type == "cuda" else None
        for shape, n, M in (("one product", one_lanes, 1), ("chain", chain_lanes, chain)):
            a, b = rand_words(spec, (n, W), 11, dev), rand_words(spec, (n, W), 12, dev)
            k = n if check_lanes is None else min(check_lanes, n)
            got = mont_tc(spec, "mont", a, b, M)
            want, plain_ms = plain_timed(lambda: mont_tc_plain(spec, "mont", a[:k], b[:k], M),
                                         dev)
            err = max_err(got[:k], want)
            if M == 1:
                other_name, other = "K1 mont_mul", lambda: mont_mul(spec, a, b)
            else:
                other_name, other = "E2 mont", lambda: probe_chain(spec, "mont", a, b, M)
            same = bool(torch.equal(got, other()))
            ms = timed_ms(lambda: mont_tc(spec, "mont", a, b, M), dev, reps)
            other_ms = timed_ms(other, dev, reps)
            bound, bound_by = work_bound(tc_work(spec, n, M), sol)
            recs.append({"probe": "E1", "body": shape, "port_body": "tc:mont", "field": f,
                         "W": W, "lanes": n, "M": M, "ms": ms,
                         **rates(None if ms is None else ms / M, n, ops, 1, 32, sol),
                         "bound_ms": bound, "bound_by": bound_by,
                         "beside": other_name, "beside_ms": other_ms, "equal_beside": same,
                         "sass": ops, "registers": registers(key), "checked_lanes": k,
                         "plain_ms": plain_ms,
                         "max_abs_err": err})
    return recs
