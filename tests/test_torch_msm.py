"""The port's MSM (blaze_tpu_torch.msm) against the JAX package and the
oracle, on the CPU (the plain versions of the kernels).

The fused MSM is held to blaze_tpu's MSM(fused="on", interpret=True) — the
Pallas kernels run in interpret mode — on one seeded input: per-window sums
and the folded result must be equal limb for limb, through both the
points-major input and the JAX package's own resident layout.  Full-width
scalars, signed digits, several chunks and precomputed multiples are held
to the python oracle.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.curves.kernels import ECKernels as RefECKernels
from blaze_tpu.msm import (
    MSM as RefMSM,
    MSMConfig as RefMSMConfig,
    points_to_resident as ref_points_to_resident,
    split_scalars as ref_split_scalars,
)
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.fields import words_to_int
from blaze_tpu_torch.msm import (
    MSM,
    MSMConfig,
    from_reference_resident,
    precompute_points,
    scalars_to_resident,
    split_scalars,
    to_reference_resident,
)
from blaze_tpu_torch.oracle import (
    ECOracle,
    class_sum_expected,
    random_msm_instance,
    tiled_msm_instance,
)
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

N, C_BITS, SCALAR_BITS = 128, 6, 12


def pm_to_ref(x: torch.Tensor) -> np.ndarray:
    """Points-major (..., W) int32 words -> (..., L) 16-bit limbs."""
    return np.ascontiguousarray(x.numpy()).view("<u2").astype(np.uint32)


def as_i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def affine(cv: Curve, out: torch.Tensor):
    """(3, W) projective Montgomery -> affine python ints (None = identity)."""
    X, Y, Z = (words_to_int(v) for v in cv.fq.from_mont(out).numpy().view(np.uint32))
    if Z == 0:
        return None
    p = cv.spec.fq.p
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


@pytest.fixture(scope="module")
def fused_case():
    """One BN254 input (12-bit scalars) through both packages' fused MSM."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    points, scalars, _, _ = tiled_msm_instance(spec, N, seed=31)
    scal = scalars.copy()
    scal[:, 0] &= 0xFFF
    scal[:, 1:] = 0
    pts = cv.fq.to_mont(as_i32(points))                       # (N, 2, W)
    rcv = RefCurve(REF_CURVES["bn254"])
    rmsm = RefMSM(rcv, RefMSMConfig(fused="on", interpret=True, kernel_tile=128))
    rpts = jnp.asarray(pm_to_ref(pts))
    rws = rmsm._fused_chunk(rpts, jnp.asarray(scal), C_BITS, SCALAR_BITS)
    kern = RefECKernels.for_curve(rcv.spec, tile=128, interpret=True)
    ws_lm = jnp.moveaxis(rws, 0, -1).reshape(-1, rws.shape[0])
    rres = rmsm._canon(kern.fold_horner(ws_lm, C_BITS).reshape(3, -1))
    return cv, pts, as_i32(scal), rcv, np.asarray(rws), np.asarray(rres)


def test_fused_window_sums_and_result_match_reference(fused_case):
    cv, pts, scal, _, rws, rres = fused_case
    msm = MSM(cv)
    ws = msm.msm_partial(pts, scal, C_BITS, SCALAR_BITS)
    assert np.array_equal(pm_to_ref(ws), rws)
    out = msm(pts, scal, window_bits=C_BITS, scalar_bits=SCALAR_BITS)
    assert np.array_equal(pm_to_ref(out), rres)


def test_reference_residency_gives_reference_result(fused_case):
    """blaze_tpu's (L, N) xy-packed residency, converted, into the port."""
    cv, pts, scal, rcv, _, rres = fused_case
    canon = cv.fq.from_mont(pts)
    ref_res = np.asarray(ref_points_to_resident(rcv, jnp.asarray(pm_to_ref(canon))))
    res = from_reference_resident(ref_res, cv)
    assert res.shape == (2 * cv.nwords, N)
    assert np.array_equal(to_reference_resident(res, cv), ref_res)
    out = MSM(cv)(res, scalars_to_resident(scal), window_bits=C_BITS,
                  scalar_bits=SCALAR_BITS)
    assert np.array_equal(pm_to_ref(out), rres)


def test_digits_and_signed_recode_match_reference():
    rng = np.random.default_rng(2)
    scal = rng.integers(0, 1 << 16, size=(16, 64), dtype=np.uint32)  # (Ls, N)
    rmsm = RefMSM(RefCurve(REF_CURVES["bn254"]))
    for c in (5, 8, 13, 16):
        nwin = -(-254 // c)
        got = MSM._digits_lm(as_i32(scal), c, nwin)
        want = rmsm._digits_lm(jnp.asarray(scal), c, nwin)
        assert np.array_equal(got.numpy(), np.asarray(want))
        mag, sgn = MSM._signed_recode(got, c)
        rmag, rsgn = rmsm._signed_recode(want, c)
        assert np.array_equal(mag.numpy(), np.asarray(rmag))
        assert np.array_equal(sgn.numpy(), np.asarray(rsgn))


@pytest.mark.parametrize("name,c,signed", [
    ("bn254", 4, False),
    ("bls12_381", 5, True),
])
def test_full_width_scalars_match_oracle(name, c, signed):
    spec = CURVES[name]
    cv = Curve(spec)
    points, scalars, expected, _ = random_msm_instance(spec, 24, seed=5)
    msm = MSM(cv, MSMConfig(signed_digits=signed))
    out = msm(cv.fq.to_mont(as_i32(points)), as_i32(scalars), window_bits=c)
    assert affine(cv, out) == expected


def test_chunked_accumulate_and_finalize_match_oracle():
    """Three chunks: per-chunk window sums accumulated (K3) and folded
    (K6), the streamed client's path."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    points, scalars, expected, _ = random_msm_instance(spec, 40, seed=6)
    msm = MSM(cv, MSMConfig(chunk_log2=4))
    out = msm(cv.fq.to_mont(as_i32(points)), as_i32(scalars), window_bits=6)
    assert affine(cv, out) == expected


def test_zero_and_duplicate_scalars_match_oracle():
    spec = CURVES["bn254"]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(7)
    pts = [oracle.random_point(rng) for _ in range(8)]
    pts[3] = pts[2]
    scalars = [0, 1, 2, spec.fr.p - 1, 7, 7, 0, 12345]
    out = MSM(cv)(cv.fq.to_mont(as_i32(points_to_affine_words(spec, pts))),
                  as_i32(scalars_to_limbs(spec, scalars)), window_bits=4)
    assert affine(cv, out) == oracle.msm(pts, scalars)


def test_precomputed_multiples_match_oracle_and_reference_split():
    spec = CURVES["bn254"]
    cv = Curve(spec)
    points, scalars, expected, _ = random_msm_instance(spec, 6, seed=8)
    sl, bits = split_scalars(as_i32(scalars), 8, spec.fr.bits)
    rsl, rbits = ref_split_scalars(jnp.asarray(scalars), 8, spec.fr.bits)
    assert bits == rbits and np.array_equal(sl.numpy(), np.asarray(rsl))
    expanded = precompute_points(cv, cv.fq.to_mont(as_i32(points)), 8)
    out = MSM(cv).msm_precomputed(expanded, as_i32(scalars), 8, window_bits=8)
    assert affine(cv, out) == expected


def test_class_sum_oracle_needs_subgroup_points():
    """The class-sum oracle (coefficient sums mod r per point class) holds
    only on the order-r subgroup: ECOracle.random_point's BLS12-381 points
    lie outside it, and there the MSM agrees with the per-point oracle but
    not with the class sums; on subgroup points all three agree."""
    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(12)
    scalars = [rng.randrange(spec.fr.p) for _ in range(8)]
    for sample, class_sum_holds in [(oracle.random_point, False),
                                    (oracle.random_subgroup_point, True)]:
        upoints = [sample(rng) for _ in range(4)]
        pts = upoints * 2
        out = MSM(cv)(cv.fq.to_mont(as_i32(points_to_affine_words(spec, pts))),
                      as_i32(scalars_to_limbs(spec, scalars)), window_bits=8)
        assert affine(cv, out) == oracle.msm(pts, scalars)
        assert (class_sum_expected(spec, upoints, scalars)
                == oracle.msm(pts, scalars)) == class_sum_holds


def window_sums(spec, nwin: int, seed: int, identities: bool) -> torch.Tensor:
    """(nwin, 3, W) canonical projective Montgomery window sums: oracle
    points at a random scale (X, Y, Z) = (lx, ly, l); with `identities`,
    windows 0, 2 and nwin - 2 are the identity (0 : 1 : 0)."""
    cv = Curve(spec)
    p = spec.fq.p
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    rows = []
    for _ in range(nwin):
        x, y = oracle.random_point(rng)
        lam = rng.randrange(1, p)
        rows.append([x * lam % p, y * lam % p, lam])
    if identities:
        for w in (0, 2, nwin - 2):
            rows[w] = [0, 1, 0]
    return cv.fq.from_int([v for r in rows for v in r]).reshape(nwin, 3, -1)


@pytest.mark.parametrize("c", [13, 16])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_finalize_on_k6_matches_field_fold(name, c):
    """`finalize` (K6: alg 7 doublings on the lazy words, canonicalized) gives
    the same projective words as the Field's Horner fold (alg 9
    doublings), at the MSM's window counts for c = 13 and 16, with random
    and with identity windows."""
    spec = CURVES[name]
    msm = MSM(Curve(spec))
    nwin = -(-spec.fr.bits // c)
    for identities in (False, True):
        ws = window_sums(spec, nwin, seed=c + identities, identities=identities)
        assert torch.equal(msm.finalize(ws, c), msm.fold_windows(ws, c)), identities


@pytest.mark.parametrize("name", sorted(CURVES))
def test_accumulate_on_k3_matches_curve_add(name):
    """`accumulate` (K3 on the lanes-major window sums, canonicalized) gives
    the Field's Curve.add words, identity windows on either side included."""
    spec = CURVES[name]
    cv, msm = Curve(spec), MSM(Curve(spec))
    a = window_sums(spec, 16, seed=1, identities=True)
    b = window_sums(spec, 16, seed=2, identities=False)
    b[5] = a[2]                                   # identity + identity
    b[7] = a[7]                                   # a doubling
    for x, y in ((a, b), (b, a)):
        assert torch.equal(msm.accumulate(x, y), cv.add(x, y))
    assert msm.accumulate(None, a) is a
