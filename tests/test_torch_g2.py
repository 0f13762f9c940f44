"""BN254's G2 on the port, on the CPU: F_p2 (fields/fp2.py) and the twist's
curve (curves/spec.py BN254_G2) against the plain reference in Python ints
(zkbench/reference/bn254_g2.py, EIP-197's constants), the plain versions
of the EC kernels' F_p2 instances (K2-K6 on PlainFp2Ops, the lazy twin of
csrc/ec_team.cuh's Fp2) against Curve's canonical group ops word for word,
and the MSM engine on G2 resident bases (the chunk, the chunk loop, signed
digits) against the reference's MSM in affine form.  The kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda.py) and, built with g++, in
tests/test_torch_ec_team.py."""
import random

import pytest
import torch

from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.curves.kernels import ECKernels
from blaze_tpu_torch.msm import MSM, MSMConfig, points_from_resident, points_to_resident
from blaze_tpu_torch.runtime import MSMClient, MSMInit
from zkbench.reference import bn254_g2 as ref

torch.set_num_threads(1)

SPEC = CURVES["bn254_g2"]
P, R = SPEC.fq.p, SPEC.fr.p


@pytest.fixture(scope="module")
def cv():
    return Curve(SPEC)


@pytest.fixture(scope="module")
def points():
    return ref.subgroup_points(16, 2023)


def affine(cv, out) -> list:
    """(..., 3, 2W) canonical projective words -> affine reference points."""
    out = out.reshape(-1, 3, cv.nwords)
    res = []
    for X, Y, Z in cv.fq.to_int(out, mont=True):
        res.append(None if Z == (0, 0) else (ref.mul(X, ref.inv(Z)), ref.mul(Y, ref.inv(Z))))
    return res


def test_constants_and_sizes():
    """b and P2 by value: P2 on the twist, r P2 the identity, 3b = 9 / (9 +
    u); the sizes follow the degree."""
    assert SPEC.degree == 2 and SPEC.coords.nwords == 16 and SPEC.coords.nlimbs == 32
    assert (SPEC.b, (SPEC.gx, SPEC.gy)) == (ref.B, ref.G)
    assert ref.on_curve(ref.G) and ref.point_mul(ref.G, R, reduce=False) is None
    assert ref.point_mul(ref.G, R - 1) == ref.neg(ref.G)
    assert ref.mul(ref.B, (9, 1)) == (3, 0)
    assert SPEC.point_bytes == 128 and SPEC.result_bytes == 192
    assert CURVES["bn254"].point_bytes == 64 and CURVES["bn254"].coords is CURVES["bn254"].fq


def test_fp2_matches_the_reference(cv):
    """Products, sums, differences, negations and inverses of F_p2 against
    Python ints, u^2 = -1, inv(0) = 0, and the Montgomery round trip."""
    rng = random.Random(1)
    vals = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + [
        (rng.randrange(P), rng.randrange(P)) for _ in range(12)]
    f = cv.fq
    a = f.from_int(vals)
    b = f.from_int(vals[::-1])
    assert f.to_int(f.from_mont(a), mont=False) == vals
    assert f.to_int(f.mul(a, b)) == [ref.mul(x, y) for x, y in zip(vals, vals[::-1])]
    assert f.to_int(f.add(a, b)) == [ref.add(x, y) for x, y in zip(vals, vals[::-1])]
    assert f.to_int(f.sub(a, b)) == [ref.sub(x, y) for x, y in zip(vals, vals[::-1])]
    assert f.to_int(f.neg(a)) == [ref.sub((0, 0), x) for x in vals]
    u = f.from_int([(0, 1)])
    assert f.to_int(f.mul(u, u)) == [(P - 1, 0)]
    inv = f.to_int(f.inv(a))
    assert inv[0] == (0, 0)
    assert inv[1:] == [ref.inv(x) for x in vals[1:]]


def test_curve_group_law_matches_the_reference(cv, points):
    """Curve's canonical ops on G2: on_curve, add, add_mixed, dbl, neg and
    scalar_mul against the reference's affine law; a point off the twist
    fails on_curve."""
    f = cv.fq
    aff = f.from_int([c for pt in points[:4] for c in pt]).reshape(4, 2, -1)
    P4 = cv.from_affine(aff)
    assert cv.on_curve(P4).all() and cv.on_curve(cv.identity((1,))).all()
    bad = P4.clone()
    bad[0, 1, 0] ^= 1
    assert not cv.on_curve(bad)[0]
    Q = cv.dbl(P4.flip(0))
    assert affine(cv, Q) == [ref.point_add(p, p) for p in points[:4][::-1]]
    want = [ref.point_add(ref.point_add(q, q), p) for p, q in zip(points[:4], points[:4][::-1])]
    assert affine(cv, cv.add(Q, P4)) == want
    assert affine(cv, cv.add_mixed(Q, aff)) == want
    assert affine(cv, cv.add(P4, cv.neg(P4))) == [None] * 4
    k = (1 << 63) + 12345
    assert affine(cv, cv.scalar_mul(P4[:1], k)) == [ref.point_mul(points[0], k)]


def test_residency_round_trip(cv, points):
    """(N, 2, 2W) affine words -> (4W, N) resident Montgomery rows -> back."""
    aff = cv.fq.from_int([c for pt in points for c in pt], mont=False).reshape(16, 2, -1)
    res = points_to_resident(cv, aff)
    assert res.shape == (32, 16) and res.is_contiguous()
    assert torch.equal(points_from_resident(cv, res), cv.fq.to_mont(aff))


def lazy_rows(cv, points, C: int, B: int, seed: int):
    aff = cv.fq.from_int([c for pt in points for c in pt]).reshape(len(points), 2, -1)
    idx = torch.from_numpy(__import__("numpy").random.default_rng(seed).integers(
        0, len(points), size=C * B))
    return aff[idx].reshape(C, B, -1).permute(0, 2, 1).contiguous()


def pm(cv, x):
    """(3W, B) lazy lanes-major -> (B, 3, W) canonical points-major."""
    return cv.fq._cond_sub_p(x.t().reshape(-1, 3, cv.nwords))


def test_plain_kernels_match_canonical_ops(cv, points):
    """K2 (unsigned and signed), K3, K4, K5 and K6's plain F_p2 versions,
    their lazy words canonicalized, equal Curve's canonical RCB ops word
    for word (alg 8 for K2's prefixes, alg 7 for the rest: a doubling is
    the complete add of a point with itself)."""
    k = ECKernels.for_curve(SPEC)
    assert k.W == 16 and k.counter("scan_gathered") == "scan_g2_gathered"
    C, B = 3, 4
    rows = lazy_rows(cv, points, C, B, 5)
    sgn = torch.tensor([[[1, 0, 1, 1]], [[0, 0, 1, 0]], [[1, 1, 0, 0]]], dtype=torch.int32)
    for signed in (False, True):
        x = torch.cat([rows, sgn], dim=1).contiguous() if signed else rows
        emitted, tot = k.scan_mixed_plain(x)
        acc = cv.identity((B,))
        for c in range(C):
            q = rows[c].t().reshape(B, 2, -1)
            if signed:
                q = torch.stack([q[:, 0], torch.where(sgn[c, 0][:, None] != 0,
                                                      cv.fq.neg(q[:, 1]), q[:, 1])], dim=1)
            acc = cv.add_mixed(acc, q)
            assert torch.equal(pm(cv, emitted[c]), acc), (signed, c)
        assert torch.equal(pm(cv, tot), acc)
    e = emitted                                            # lazy prefixes, identities too
    e[1, :, 1] = cv.identity().reshape(-1)
    p, q = e[0].contiguous(), e[2].contiguous()
    P_, Q_ = pm(cv, p), pm(cv, q)
    assert torch.equal(pm(cv, k.add_plain(p, q)), cv.add(P_, Q_))
    assert torch.equal(pm(cv, k.add_plain(p, p)), cv.add(P_, P_))
    acc = cv.identity((B,))
    for c in range(C):
        acc = cv.add(acc, pm(cv, e[c]))
    assert torch.equal(pm(cv, k.reduce_cols_plain(e)), acc)
    d = P_
    for _ in range(3):
        d = cv.add(d, d)
    assert torch.equal(pm(cv, k.dbl_n_plain(p, 3)), d)
    ws, c_ = q, 2                                          # 4 windows of c = 2
    acc = Q_[-1:]
    for w in range(2, -1, -1):
        for _ in range(c_):
            acc = cv.add(acc, acc)
        acc = cv.add(acc, Q_[w:w + 1])
    got = k.fold_horner_plain(ws, c_)
    assert torch.equal(cv.fq._cond_sub_p(got.reshape(3, -1)), acc[0])


def msm_case(cv, points, n: int, seed: int, bits: int = 254):
    """Resident bases (16 points tiled), (Ls, n) limbs of `bits`-bit scalars
    and the reference's MSM."""
    tiled = [points[i % len(points)] for i in range(n)]
    rng = random.Random(seed)
    scalars = [rng.randrange(min(R, 1 << bits)) for _ in range(n)]
    aff = cv.fq.from_int([c for pt in tiled for c in pt], mont=False).reshape(n, 2, -1)
    limbs = torch.tensor([[(s >> (16 * l)) & 0xFFFF for l in range(-(-bits // 16))]
                          for s in scalars], dtype=torch.int32).t().contiguous()
    return points_to_resident(cv, aff), limbs, ref.msm(tiled, scalars)


def test_msm_one_chunk_matches_reference(cv, points):
    """MSM.__call__ on 2^8 resident G2 bases of full-width scalars at c =
    4: one chunk, the K6 fold, the canonical projective result equal in
    affine form to the reference's MSM."""
    res, limbs, want = msm_case(cv, points, 1 << 8, 7)
    msm = MSM(cv)
    out = msm(res, limbs, window_bits=4)
    assert out.shape == (3, 16)
    assert affine(cv, out) == [want]
    assert list(msm.chunk_plans) == [(64, 256, 16)]


def test_msm_chunks_and_signed_digits_match_reference(cv, points):
    """2^10 bases in four chunks (chunk_log2 8) with balanced digits at c =
    5, over 64-bit scalars (13 windows): the chunk loop's accumulation on K3
    and the signed K2 path, equal in affine form to the reference's MSM."""
    res, limbs, want = msm_case(cv, points, 1 << 10, 11, bits=64)
    msm = MSM(cv, MSMConfig(chunk_log2=8, signed_digits=True))
    out = msm(res, limbs, window_bits=5, scalar_bits=64)
    assert affine(cv, out) == [want]
    assert msm.chunk_plans == {(13, 256, 16): 4}


def test_msm_client_stays_g1():
    with pytest.raises(ValueError, match="G1"):
        MSMClient(MSMInit(curve="bn254_g2"), device="cpu")
