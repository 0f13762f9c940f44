"""The port's curve layer against the JAX package: the plain versions of the
EC kernels K2-K6 (blaze_tpu_torch.curves.kernels) against blaze_tpu's Pallas
EC kernels run in interpret mode, limb for limb in the lazy < 2p range; the
canonical group law against blaze_tpu's Curve; the point codecs' bytes.

Inputs are oracle points made from a seed, and the lazy prefixes the scan
emits (so K3-K6 see values in [p, 2p) as well).
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.curves.kernels import ECKernels as RefECKernels
from blaze_tpu_torch.curves import (
    CURVES,
    Curve,
    decode_affine_points,
    decode_projective_result,
    encode_affine_points,
    encode_projective_result,
)
from blaze_tpu_torch.curves.kernels import ECKernels
from blaze_tpu_torch.oracle import ECOracle

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

C, B = 3, 128


def words_to_ref(x: torch.Tensor, k: int) -> np.ndarray:
    """Lanes-major (..., k*W, B) int32 words -> (..., k*L, B) 16-bit limbs."""
    *lead, kW, n = x.shape
    w = x.numpy().view(np.uint32).reshape(*lead, kW, n)
    w = np.moveaxis(w, -1, -2).copy()                    # (..., B, k*W)
    limbs = w.view("<u2").astype(np.uint32)              # (..., B, k*L)
    return np.ascontiguousarray(np.moveaxis(limbs, -1, -2))


def ref_to_words(x) -> torch.Tensor:
    """(..., k*L, B) 16-bit limbs -> (..., k*W, B) int32 words."""
    a = np.moveaxis(np.asarray(x, dtype=np.uint32), -1, -2).astype("<u2").copy()
    w = np.moveaxis(a.view("<u4"), -1, -2)
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def pm_to_ref(x: torch.Tensor) -> np.ndarray:
    """Points-major (..., W) int32 words -> (..., L) 16-bit limbs."""
    return np.ascontiguousarray(x.numpy()).view("<u2").astype(np.uint32)


def affine_rows(name: str, seed: int):
    """(C, 2W, B) Montgomery affine rows of oracle points, their (C, L, B)
    xy-packed reference form, and a (C, B) 0/1 sign row."""
    spec = CURVES[name]
    cv = Curve(spec)
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    pts = [oracle.random_point(rng) for _ in range(C * B)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts]),
                       cv.fq.from_int([y for _, y in pts])], dim=1)   # (CB, 2, W)
    rows = aff.reshape(C, B, -1).permute(0, 2, 1).contiguous()        # (C, 2W, B)
    limbs = words_to_ref(rows, 2)                                     # (C, 2L, B)
    L = spec.fq.nlimbs
    packed = limbs[:, :L] | (limbs[:, L:] << 16)
    sgn = np.random.default_rng(seed).integers(0, 2, size=(C, B)).astype(np.int32)
    return rows, packed, sgn


@pytest.fixture(scope="module", params=["bn254", "bls12_381"])
def case(request):
    name = request.param
    rows, packed, sgn = affine_rows(name, seed=11)
    return (name, ECKernels.for_curve(CURVES[name]),
            RefECKernels.for_curve(REF_CURVES[name], tile=128, interpret=True),
            rows, packed, sgn)


def test_scan_mixed_plain_matches_reference(case):
    name, k, ref, rows, packed, _ = case
    emitted, tot = k.scan_mixed(rows)
    r_emitted, r_tot = ref.scan_mixed(jnp.asarray(packed))
    assert np.array_equal(words_to_ref(emitted, 3), np.asarray(r_emitted))
    assert np.array_equal(words_to_ref(tot, 3), np.asarray(r_tot))


def test_scan_mixed_signed_plain_matches_reference(case):
    name, k, ref, rows, packed, sgn = case
    rows_s = torch.cat([rows, torch.from_numpy(sgn)[:, None]], dim=1).contiguous()
    emitted, tot = k.scan_mixed(rows_s)
    r_emitted, r_tot = ref.scan_mixed(
        jnp.asarray(np.concatenate([packed, sgn[:, None].astype(np.uint32)], axis=1))
    )
    assert np.array_equal(words_to_ref(emitted, 3), np.asarray(r_emitted))
    assert np.array_equal(words_to_ref(tot, 3), np.asarray(r_tot))


@pytest.fixture(scope="module")
def lazy_points(case):
    """Lazy (< 2p) projective prefixes of the scan, (C, 3W, B)."""
    return case[1].scan_mixed(case[3])[0]


def test_add_plain_matches_reference(case, lazy_points):
    _, k, ref, *_ = case
    p, q = lazy_points[0].contiguous(), lazy_points[-1].contiguous()
    got = k.add(p, q)
    want = ref.add(jnp.asarray(words_to_ref(p, 3)), jnp.asarray(words_to_ref(q, 3)))
    assert np.array_equal(words_to_ref(got, 3), np.asarray(want))


def test_reduce_cols_plain_matches_reference(case, lazy_points):
    _, k, ref, *_ = case
    got = k.reduce_cols(lazy_points)
    want = ref.reduce_cols(jnp.asarray(words_to_ref(lazy_points, 3)))
    assert np.array_equal(words_to_ref(got, 3), np.asarray(want))


def test_dbl_n_plain_matches_reference(case, lazy_points):
    _, k, ref, *_ = case
    p = lazy_points[1].contiguous()
    got = k.dbl_n(p, 2)
    want = ref.dbl_n(jnp.asarray(words_to_ref(p, 3)), 2)
    assert np.array_equal(words_to_ref(got, 3), np.asarray(want))


def test_fold_horner_plain_matches_reference(case, lazy_points):
    _, k, ref, *_ = case
    ws = lazy_points[-1, :, :4].contiguous()              # Wn = 4 window sums
    got = k.fold_horner(ws, 3)
    want = ref.fold_horner(jnp.asarray(words_to_ref(ws, 3)), 3)
    assert np.array_equal(words_to_ref(got[:, None], 3)[:, 0], np.asarray(want))


@pytest.mark.parametrize("name", ["bn254", "bls12_377"])
def test_curve_group_law_matches_reference(name):
    """Canonical add / dbl / neg on the port's Field vs blaze_tpu's Curve,
    and the sum against the oracle."""
    spec = CURVES[name]
    cv, rcv = Curve(spec), RefCurve(REF_CURVES[name])
    oracle = ECOracle(spec)
    rng = random.Random(3)
    a, b = oracle.random_point(rng), oracle.random_point(rng)
    pa = cv.from_affine(torch.stack([cv.fq.from_int(list(a))]))[0]
    pb = cv.from_affine(torch.stack([cv.fq.from_int(list(b))]))[0]
    ra, rb = jnp.asarray(pm_to_ref(pa)), jnp.asarray(pm_to_ref(pb))
    for got, want in [(cv.add(pa, pb), rcv.add(ra, rb)), (cv.dbl(pa), rcv.dbl(ra)),
                      (cv.neg(pa), rcv.neg(ra)),
                      (cv.add(pa, cv.identity()), rcv.add(ra, rcv.identity()))]:
        assert np.array_equal(pm_to_ref(got), np.asarray(want))
    aff = cv.to_affine(cv.add(pa, pb))
    assert tuple(cv.fq.to_int(aff)) == oracle.add(a, b)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_point_codecs_round_trip(name):
    spec = CURVES[name]
    oracle = ECOracle(spec)
    rng = random.Random(4)
    pts = [oracle.random_point(rng) for _ in range(3)]
    raw = b"".join(x.to_bytes(spec.fq.nbytes, "little") + y.to_bytes(spec.fq.nbytes, "little")
                   for x, y in pts)
    arr = decode_affine_points(raw, spec)
    assert arr.shape == (3, 2, spec.fq.nwords)
    assert encode_affine_points(arr, spec) == raw
    res = encode_projective_result(np.stack([arr[0, 0], arr[0, 1], arr[1, 0]]), spec)
    assert len(res) == spec.result_bytes
    assert res[: spec.fq.nbytes] == raw[2 * spec.fq.nbytes: 3 * spec.fq.nbytes]  # z first
    assert np.array_equal(decode_projective_result(res, spec),
                          np.stack([arr[0, 0], arr[0, 1], arr[1, 0]]))
