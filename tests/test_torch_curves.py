"""The port's curve layer against the JAX package: the plain versions of the
EC kernels K2-K6 (blaze_tpu_torch.curves.kernels) against blaze_tpu's Pallas
EC kernels run in interpret mode, limb for limb in the lazy < 2p range; the
canonical group law against blaze_tpu's Curve; the point codecs' bytes.

Inputs are oracle points made from a seed, and the lazy prefixes the scan
emits (so K3-K6 see values in [p, 2p) as well).
"""
import math
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.curves.kernels import ECKernels as RefECKernels
from blaze_tpu_torch.curves import (
    CURVES,
    G1_CURVES,
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


@pytest.mark.parametrize("name", sorted(G1_CURVES))
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


def sorted_chunk(name: str, N: int, G: int, signed: bool, seed: int):
    """A chunk as the MSM sorts it: (2W, N) resident words (distinct values
    below p), (G, N) int64 sort keys of random digits (bit 0 the sign when
    `signed`) and their stable argsort."""
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = CURVES[name]
    W = spec.fq.nwords
    pts = rand_words(spec.fq, (2, W, N), seed, "cpu").reshape(2 * W, N)
    g = torch.Generator().manual_seed(seed)
    key = torch.randint(0, 1 << 6, (G, N), generator=g, dtype=torch.int64)
    if signed:
        key = (key << 1) | torch.randint(0, 2, (G, N), generator=g, dtype=torch.int64)
    return pts, key, torch.argsort(key, dim=-1, stable=True)


@pytest.mark.parametrize("name,N,R,signed", [
    ("bls12_381", 256, 16, False),         # W = 12, R C = N
    ("bls12_381", 256, 16, True),          # W = 12, the sign read through the sort
    ("bn254", 1000, 32, False),            # W = 8, R C = 1024: 24 pads
])
def test_scan_gathered_plain_matches_rows(name, N, R, signed):
    """K2's gathered entry (its plain version on the CPU) equals
    scan_mixed_plain on rows made lane by lane: lane g R + r of row c the
    point at sorted position min(r C + c, N - 1) of window g, its sign
    bit 0 of that point's key."""
    G = 3
    k = ECKernels.for_curve(CURVES[name])
    pts, key, order = sorted_chunk(name, N, G, signed, seed=N + signed)
    C = -(-N // R)
    pos = (torch.arange(R)[:, None] * C + torch.arange(C)).clamp(max=N - 1)   # (R, C)
    idx = torch.gather(order, 1, pos.reshape(1, -1).expand(G, -1))         # (G, R C)
    rows = pts[:, idx].reshape(-1, G, R, C).permute(3, 0, 1, 2)           # (C, 2W, G, R)
    if signed:
        sgn = (torch.gather(key, 1, idx) & 1).to(torch.int32).reshape(1, G, R, C)
        rows = torch.cat([rows, sgn.permute(3, 0, 1, 2)], dim=1)
    rows = rows.reshape(C, -1, G * R).contiguous()
    emitted, tot = k.scan_gathered(pts, order, R, C, key if signed else None)
    want_e, want_t = k.scan_mixed_plain(rows)
    assert emitted.shape == (C, 3 * k.W, G * R)
    assert torch.equal(emitted, want_e) and torch.equal(tot, want_t)


def test_scan_gathered_refuses_bad_operands():
    """Too few lanes for the points, an int32 order, a sort key of another
    shape and points of the wrong width or points-major raise before any
    scan."""
    k = ECKernels.for_curve(CURVES["bn254"])
    pts, key, order = sorted_chunk("bn254", 64, 2, True, seed=1)
    for args in [(pts, order, 7, 9), (pts, order.to(torch.int32), 8, 8),
                 (pts[:-1], order, 8, 8), (pts.t().contiguous(), order, 8, 8)]:
        with pytest.raises(ValueError):
            k.scan_gathered(*args)
    with pytest.raises(ValueError):
        k.scan_gathered(pts, order, 8, 8, key[:, :-1])


def bucket_case(name: str, G: int, R: int, C: int, c: int, signed: bool, seed: int):
    """A chunk's bucket step inputs: K2's emitted (C, 3W, G R) and the
    inclusive lane prefix x (3W, G R) as words below p, and the (G, B)
    bounds of random digits as the MSM makes them (signed: B = 2^(c-1) + 1
    buckets of magnitudes).  Window 0's digits skip the lowest buckets, so
    its first bounds are -1 (empty); the last window's bucket 0 holds one
    point, so its bound lies in lane 0."""
    from blaze_tpu_torch.oracle.gen import rand_words

    W = CURVES[name].fq.nwords
    N = R * C
    emitted = rand_words(CURVES[name].fq, (3 * C, W, G * R), seed, "cpu")
    x = rand_words(CURVES[name].fq, (3, W, G * R), seed + 1, "cpu")
    B = (1 << (c - 1)) + 1 if signed else 1 << c
    g = torch.Generator().manual_seed(seed)
    digits = torch.randint(0, B, (G, N), generator=g, dtype=torch.int64)
    digits[0] = digits[0].clamp(min=3)
    digits[-1] = digits[-1].clamp(min=1)
    digits[-1, 0] = 0
    hist = torch.zeros((G, B), dtype=torch.int64)
    hist.scatter_add_(1, digits, torch.ones_like(digits))
    bounds = torch.cumsum(hist, dim=-1) - 1
    return emitted.reshape(C, 3 * W, G * R), x.reshape(3 * W, G * R), bounds, B


def chunk_rows_before(k, emitted, x, bounds, C, R, B):
    """The bucket step's rows as the MSM chunk made them with torch before
    K4 read them in place: the bound gathers, the `where`s, the cat of
    carries and locals, the identity pad and the permute."""
    G = bounds.shape[0]
    threeW = 3 * k.W
    ident = k.ident_col("cpu")
    excl = torch.cat([ident.reshape(threeW, 1, 1).expand(threeW, G, 1),
                      x.reshape(threeW, G, R)[:, :, :-1]], dim=2).permute(1, 2, 0)
    safe = bounds.clamp(min=0)
    lane_idx, col_idx = safe // C, safe % C
    gidx = torch.arange(G)[:, None]
    local = emitted[col_idx, :, gidx * R + lane_idx]
    carry = excl[gidx, lane_idx]
    valid = (bounds >= 0)[..., None]
    local = torch.where(valid, local, ident.reshape(1, 1, -1))
    carry = torch.where(valid, carry, ident.reshape(1, 1, -1))
    pts = torch.cat([carry[:, : B - 1], local[:, : B - 1]], dim=1)
    M = pts.shape[1]
    R2 = 1 << max(0, (int(math.sqrt(max(M, 4))) - 1).bit_length())
    C2 = -(-M // R2)
    pad = R2 * C2 - M
    if pad:
        pts = torch.cat([pts, ident.reshape(1, 1, threeW).expand(G, pad, threeW)], dim=1)
    rows = pts.reshape(G, R2, C2, threeW).permute(2, 3, 0, 1)
    return rows.reshape(C2, threeW, G * R2).contiguous()


@pytest.mark.parametrize("name,G,R,C,c,signed", [
    ("bn254", 3, 4, 8, 3, False),          # B 8, M 14 on 4 lanes of 4: 2 pads
    ("bn254", 2, 8, 4, 4, True),           # B 9, M 16: no pad
    ("bls12_381", 2, 4, 16, 5, False),     # W = 12, B 32, M 62 on 8 lanes of 8: 2 pads
    ("bls12_381", 3, 2, 8, 3, True),       # B 5, M 8
])
def test_bucket_rows_match_the_chunk_composition(name, G, R, C, c, signed):
    """bucket_rows (the rows K4's gathered form reads in place) equals the
    MSM chunk's old torch composition word for word: unsigned and signed
    digits, empty buckets (bounds -1), bounds in lane 0 (identity
    carries) and padded lists."""
    k = ECKernels.for_curve(CURVES[name])
    emitted, x, bounds, B = bucket_case(name, G, R, C, c, signed, seed=G + c)
    assert (bounds[0, :3] == -1).all() and ((bounds >= 0) & (bounds < C)).any()
    got = k.bucket_rows(emitted, x, bounds, C, R, B)
    R2, C2 = k.bucket_lanes(B)
    assert got.shape == (C2, 3 * k.W, G * R2) and R2 * C2 >= 2 * (B - 1)
    assert torch.equal(got, chunk_rows_before(k, emitted, x, bounds, C, R, B))


@pytest.mark.parametrize("signed", [False, True])
def test_reduce_buckets_plain_is_reduce_cols_of_bucket_rows(signed):
    """reduce_buckets on the CPU (its plain version) equals reduce_cols_plain
    of bucket_rows, and launches nothing."""
    from blaze_tpu_torch import _build

    k = ECKernels.for_curve(CURVES["bn254"])
    C, R = 8, 4
    emitted, x, bounds, B = bucket_case("bn254", 2, R, C, 3, signed, seed=7 + signed)
    before = dict(_build.LAUNCHES)
    got = k.reduce_buckets(emitted, x, bounds, C, R, B)
    assert _build.LAUNCHES == before
    R2, _ = k.bucket_lanes(B)
    assert got.shape == (3 * k.W, 2 * R2)
    assert torch.equal(got, k.reduce_cols_plain(k.bucket_rows(emitted, x, bounds, C, R, B)))


def test_reduce_buckets_refuses_bad_operands():
    """int32 bounds, bounds of another bucket count, int64 words, emitted or
    x of other lanes or steps, operands on two devices, one bucket, and
    G R C >= 2^31 (positions are 32-bit) raise before any sum."""
    k = ECKernels.for_curve(CURVES["bn254"])
    C, R = 8, 4
    emitted, x, bounds, B = bucket_case("bn254", 2, R, C, 3, False, seed=1)
    for args in [(emitted, x, bounds.to(torch.int32), C, R, B),
                 (emitted, x, bounds, C, R, B + 1),
                 (emitted.to(torch.int64), x, bounds, C, R, B),
                 (emitted, x[:, :-1], bounds, C, R, B),
                 (emitted[:-1], x, bounds, C, R, B),
                 (emitted, x, bounds, C, 2 * R, B),
                 (emitted, x, bounds.to("meta"), C, R, B),
                 (emitted, x, bounds[:, :1], C, R, 1)]:
        with pytest.raises(ValueError):
            k.reduce_buckets(*args)
    G, R, C = 2, 1 << 15, 1 << 15
    big = torch.empty((C, 3 * k.W, G * R), dtype=torch.int32, device="meta")
    xb = torch.empty((3 * k.W, G * R), dtype=torch.int32, device="meta")
    bb = torch.empty((G, B), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        k.reduce_buckets(big, xb, bb, C, R, B)
