"""MSM test-instance generators, including the reference's tiling trick.

The reference keeps large-size oracle computation cheap by generating only
LARGE_PARAM=256 unique (point, scalar) pairs and tiling them
(`blaze/tests/msm/mod.rs:23-31`, tiling at 92-109), so the expected
result is `(N / 256) * msm(unique) + partial`.  Same trick here.

Points come out as uint32[N, 2, W] canonical 32-bit words and scalars as
uint32[N, Ls] 16-bit limbs — the forms the port's codecs decode to.
"""
from __future__ import annotations

import random

import numpy as np

from ..curves.spec import CurveSpec
from ..fields.spec import int_to_limbs, int_to_words
from .ec import ECOracle

LARGE_PARAM = 256  # tests/msm/mod.rs:23 `get_large_param` cap


def points_to_affine_words(spec: CurveSpec, points) -> np.ndarray:
    W = spec.fq.nwords
    out = np.zeros((len(points), 2, W), dtype=np.uint32)
    for i, (x, y) in enumerate(points):
        out[i, 0] = int_to_words(x, W)
        out[i, 1] = int_to_words(y, W)
    return out


def scalars_to_limbs(spec: CurveSpec, scalars) -> np.ndarray:
    L = spec.fr.nlimbs
    out = np.zeros((len(scalars), L), dtype=np.uint32)
    for i, s in enumerate(scalars):
        out[i] = int_to_limbs(s, L)
    return out


def random_msm_instance(spec: CurveSpec, n: int, seed: int = 0):
    """n unique pairs + expected result. O(n) oracle cost — keep n small."""
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    points = [oracle.random_point(rng) for _ in range(n)]
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    expected = oracle.msm(points, scalars)
    return (
        points_to_affine_words(spec, points),
        scalars_to_limbs(spec, scalars),
        expected,
        {"points": points, "scalars": scalars},
    )


def tiled_msm_instance(spec: CurveSpec, n: int, seed: int = 0):
    """n pairs built by tiling <=256 unique ones; cheap exact expected value."""
    uniq = min(n, LARGE_PARAM)
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_point(rng) for _ in range(uniq)]
    uscalars = [rng.randrange(spec.fr.p) for _ in range(uniq)]

    reps, rem = divmod(n, uniq)
    # expected = reps * msm(all uniq) + msm(first rem uniq)
    full = oracle.msm(upoints, uscalars)
    expected = None
    for _ in range(reps):
        expected = oracle.add(expected, full)
    if rem:
        expected = oracle.add(expected, oracle.msm(upoints[:rem], uscalars[:rem]))

    up = points_to_affine_words(spec, upoints)
    us = scalars_to_limbs(spec, uscalars)
    idx = np.arange(n) % uniq
    return up[idx], us[idx], expected, {"points": upoints, "scalars": uscalars}


def class_sum_expected(spec: CurveSpec, upoints, scalars) -> tuple | None:
    """Expected MSM when point i is upoints[i % len(upoints)] and every
    scalar is distinct: the direct coefficient sum of each point class mod
    r, then the oracle MSM over the classes (no closed form to trust).

    Reducing the sums mod r is valid only for points of the order-r
    subgroup (ECOracle.random_subgroup_point); ECOracle.random_point's may
    lie outside it on BLS12 curves, whose G1 cofactor is not 1."""
    k = len(upoints)
    coeffs = [0] * k
    for i, s in enumerate(scalars):
        coeffs[i % k] = (coeffs[i % k] + s) % spec.fr.p
    return ECOracle(spec).msm(upoints, coeffs)
