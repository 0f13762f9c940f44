"""The MSM's precomputed mode on resident operands held to the JAX package
on the CPU, on the same inputs: `precompute_resident` word for word
against its `precompute_points`, and the resident `MSM.msm_precomputed`
against its `MSM.msm_precomputed` (one fused chunk, the Pallas kernels in
interpret mode), both against the python oracle."""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.msm import MSM as RefMSM, MSMConfig as RefMSMConfig
from blaze_tpu.msm.precompute import precompute_points as ref_precompute_points
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.fields import words_to_int
from blaze_tpu_torch.msm import (
    MSM,
    points_from_resident,
    points_to_resident,
    precompute_resident,
    scalars_to_resident,
)
from blaze_tpu_torch.oracle import ECOracle
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)


def pm_to_ref(x: torch.Tensor) -> np.ndarray:
    """Points-major (..., W) int32 words -> (..., L) 16-bit limbs."""
    return np.ascontiguousarray(x.numpy()).view("<u2").astype(np.uint32)


def as_i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def affine(cv: Curve, out: torch.Tensor):
    p = cv.spec.fq.p
    X, Y, Z = (words_to_int(v) for v in cv.fq.from_mont(out).numpy().view(np.uint32))
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


@pytest.fixture(scope="module", params=[("bn254", 8, 7), ("bls12_381", 4, 5)],
                ids=["bn254-8", "bls12_381-4"])
def case(request):
    """n oracle points in Montgomery words, their expansion by the port
    (precompute_resident, (2W, factor n), blocks of 3 with a ragged last
    one) and by the JAX package (precompute_points, (factor n, 2, L)
    limbs)."""
    name, factor, n = request.param
    spec = CURVES[name]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(80 + n)
    points = [oracle.random_subgroup_point(rng) for _ in range(n)]
    pm = cv.fq.to_mont(as_i32(points_to_affine_words(spec, points)))
    got = precompute_resident(cv, points_to_resident(cv, pm, mont=True), factor, block=3)
    want = np.asarray(ref_precompute_points(RefCurve(REF_CURVES[name]),
                                            jnp.asarray(pm_to_ref(pm)), factor))
    return name, factor, cv, oracle, points, got, want


def test_precompute_resident_equals_the_jax_packages_expansion(case):
    """The same multiples in the same multiple-major order, Montgomery
    affine, word for word."""
    _, factor, cv, _, points, got, want = case
    assert want.shape == (factor * len(points), 2, 2 * cv.nwords)
    assert np.array_equal(pm_to_ref(points_from_resident(cv, got)), want)


def test_resident_precomputed_msm_equals_the_jax_packages(case):
    """On the same multiples and unsliced scalars (c = 8), the resident
    precomputed MSM and the JAX package's give the same point, the
    oracle's MSM of the scalars over the bases."""
    name, factor, cv, oracle, points, res, _ = case
    n = len(points)
    rng = random.Random(91 + n)
    scalars = [rng.randrange(cv.spec.fr.p) for _ in range(n)]
    limbs = scalars_to_limbs(cv.spec, scalars)
    out = MSM(cv).msm_precomputed(res, scalars_to_resident(as_i32(limbs)), factor,
                                  window_bits=8)
    rmsm = RefMSM(RefCurve(REF_CURVES[name]),
                  RefMSMConfig(fused="on", interpret=True, kernel_tile=128))
    rout = rmsm.msm_precomputed(jnp.asarray(pm_to_ref(points_from_resident(cv, res))),
                                jnp.asarray(limbs), factor, window_bits=8)
    ref = torch.from_numpy(np.ascontiguousarray(np.asarray(rout), dtype=np.uint16)
                           .view(np.int32).copy())
    want = oracle.msm(points, scalars)
    assert affine(cv, ref) == want
    assert affine(cv, out) == want
