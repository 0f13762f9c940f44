"""The reference's BN254 (reference/bn254.py): EIP-196's constants agree
with the program's, its points are of order r, and the program's
precomputed MSM over resident multiples agrees with the reference's MSM of
the unsliced scalars at a tiny size."""
import random

import numpy as np
import torch

from zkbench.reference import bn254, ec, fields


def test_constants_agree_with_the_program():
    from blaze_tpu_torch.curves import CURVES

    g1, spec = ec.G1("bn254"), CURVES["bn254"]
    assert (g1.p, g1.r, g1.b, g1.g) == (spec.fq.p, spec.fr.p, spec.b, (spec.gx, spec.gy))
    assert (bn254.P, bn254.R) == (g1.p, g1.r)


def test_points_are_on_the_curve_and_of_order_r():
    g1 = ec.G1("bn254")
    pts = ec.subgroup_points("bn254", 4, 13)
    assert len(set(pts)) == 4 and all(g1.on_curve(P) for P in pts)
    assert all(g1.mul(P, g1.r) is None for P in pts) and g1.on_curve(g1.g)


def test_the_programs_precomputed_msm_agrees_with_the_reference():
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.msm import MSM, points_to_resident, precompute_resident

    g1, cv = ec.G1("bn254"), Curve(CURVES["bn254"])
    pts = ec.subgroup_points("bn254", 4, 3)
    rng = random.Random(3)
    scalars = [rng.randrange(g1.r) for _ in range(4)]
    xy = fields.ints_to_words([c for P in pts for c in P], 8).view(np.int32)
    res = precompute_resident(cv, points_to_resident(cv, torch.from_numpy(xy.reshape(4, 2, 8))), 8)
    sc = torch.from_numpy(fields.ints_to_limbs16(scalars, 16).astype(np.int32)).t()
    X, Y, Z = fields.words_to_ints(MSM(cv).msm_precomputed(res, sc.contiguous(), 8).numpy())
    zi = pow(Z, -1, g1.p)
    assert (X * zi % g1.p, Y * zi % g1.p) == g1.msm(pts, scalars)
