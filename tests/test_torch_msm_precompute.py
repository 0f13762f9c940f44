"""The MSM's precomputed mode on resident operands, on the CPU (the plain
versions of the kernels): `MSM.msm_precomputed` over (2W, factor*N)
multiple-major bases and the unsliced (Ls, N) scalars, against the python
oracle and against the plain MSM of the same scalars over the bases alone;
`precompute_resident` against `precompute_points` word for word; and
`scalar_rows` against `split_scalars`.  The JAX package's side is in
test_torch_msm_precompute_ref.py."""
import random

import numpy as np
import pytest
import torch

from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.fields import words_to_int
from blaze_tpu_torch.msm import (
    MSM,
    MSMConfig,
    points_to_resident,
    precompute_points,
    precompute_resident,
    scalar_rows,
    scalars_to_resident,
    shift_bits_for,
    split_scalars,
)
from blaze_tpu_torch.oracle import ECOracle
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)


def as_i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def affine(cv: Curve, out: torch.Tensor):
    p = cv.spec.fq.p
    X, Y, Z = (words_to_int(v) for v in cv.fq.from_mont(out).numpy().view(np.uint32))
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


def resident_points(cv: Curve, points) -> torch.Tensor:
    """Affine oracle points -> (2W, n) resident Montgomery words."""
    return points_to_resident(cv, as_i32(points_to_affine_words(cv.spec, points)))


# at c = 8 the plan grows a chunk of 64-bit slices (G = 8) by k = 2 and one
# of 32-bit slices (G = 4) by k = 4: chunk_log2 is log2 k lower where the
# chunks are to cross within a multiple
@pytest.mark.parametrize("name, factor, chunk_log2, n", [
    ("bn254", 8, 19, 16),          # one chunk per multiple
    ("bn254", 4, 1, 10),           # three chunks per multiple, the last ragged
    ("bls12_381", 8, 1, 16),       # two whole chunks per multiple
    ("bls12_381", 4, 19, 6),
])
def test_resident_precomputed_msm_matches_oracle_and_plain_msm(name, factor, chunk_log2, n):
    """The oracle's multiples 2^(shift i) P_n, multiple-major, and n
    full-width scalars: the precomputed MSM at c = 8 equals the oracle's
    MSM and the plain MSM of the unsliced scalars over the n bases.  Every
    chunk reads its bases' columns and its scalars' limb rows in place
    (views of the operands: no sliced copy), and no chunk straddles two
    multiples."""
    spec = CURVES[name]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(40 + n)
    points = [oracle.random_subgroup_point(rng) for _ in range(n)]
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    shift = shift_bits_for(spec.fr.bits, factor)
    expanded = [oracle.mul(pt, 1 << (shift * i)) for i in range(factor) for pt in points]
    bases = resident_points(cv, expanded)
    sc = scalars_to_resident(as_i32(scalars_to_limbs(spec, scalars)))

    msm = MSM(cv, MSMConfig(chunk_log2=chunk_log2))
    chunk = msm._chunk
    seen = []

    def recording(pts, rows, c, bits):
        seen.append((pts.untyped_storage().data_ptr(), rows.untyped_storage().data_ptr(),
                     pts.storage_offset() // pts.stride(1), rows.shape, bits))
        return chunk(pts, rows, c, bits)

    msm._chunk = recording
    out = msm.msm_precomputed(bases, sc, factor, window_bits=8)
    want = oracle.msm(points, scalars)
    assert affine(cv, out) == want
    plain = MSM(cv)(resident_points(cv, points), sc, window_bits=8)
    assert affine(cv, plain) == want

    plan = msm.plan(n, 8, shift)
    starts = [i * n + lo for i in range(factor) for lo in range(0, n, plan.points)]
    assert [s[2] for s in seen] == starts
    assert sum(msm.chunk_plans.values()) == len(starts)
    assert all(p.windows == plan.windows and p.points <= plan.points for p in msm.chunk_plans)
    assert all(s[0] == bases.untyped_storage().data_ptr() for s in seen)
    assert all(s[1] == sc.untyped_storage().data_ptr() for s in seen)
    assert all(s[3][0] == shift // 16 and s[4] == shift for s in seen)


def test_resident_precomputed_msm_refuses_a_bases_count_that_is_not_factor_times_n():
    spec = CURVES["bn254"]
    cv = Curve(spec)
    bases = torch.zeros((2 * cv.nwords, 8 * 4 + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        MSM(cv).msm_precomputed(bases, torch.zeros((16, 4), dtype=torch.int32), 8)


@pytest.mark.parametrize("name, factor, scalar_bits, n, block", [
    ("bn254", 8, None, 10, 4),            # the 8x mode's 32-bit shifts, a ragged last block
    ("bls12_381", 4, 64, 9, 3),           # 16-bit shifts, whole blocks
])
def test_precompute_resident_equals_precompute_points_word_for_word(
        name, factor, scalar_bits, n, block):
    spec = CURVES[name]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(60 + n)
    points = [oracle.random_subgroup_point(rng) for _ in range(n)]
    pm = cv.fq.to_mont(as_i32(points_to_affine_words(spec, points)))
    want = points_to_resident(cv, precompute_points(cv, pm, factor, scalar_bits), mont=True)
    got = precompute_resident(cv, points_to_resident(cv, pm, mont=True), factor,
                              scalar_bits, block=block)
    assert got.shape == (2 * cv.nwords, factor * n) and torch.equal(got, want)
    shift = shift_bits_for(scalar_bits or spec.fr.bits, factor)
    xy = cv.fq.from_mont(got[:, -1].reshape(2, -1)).numpy().view(np.uint32)
    assert tuple(words_to_int(v) for v in xy) == oracle.mul(points[-1], 1 << (shift * (factor - 1)))


@pytest.mark.parametrize("factor", [1, 2, 3, 4, 8])
def test_scalar_rows_are_split_scalars_in_the_resident_layout(factor):
    """Block i of scalar_rows is multiple i's rows of split_scalars,
    transposed; every block whole inside the scalars is a view of them."""
    spec = CURVES["bls12_381"]
    rng = random.Random(70 + factor)
    n = 5
    limbs = as_i32(scalars_to_limbs(spec, [rng.randrange(spec.fr.p) for _ in range(n)]))
    sliced, bits = split_scalars(limbs, factor, spec.fr.bits)
    res = scalars_to_resident(limbs)
    blocks, rbits = scalar_rows(res, factor, spec.fr.bits)
    assert rbits == bits and len(blocks) == factor
    for i, rows in enumerate(blocks):
        assert torch.equal(rows, sliced[i * n:(i + 1) * n].t())
        if (i + 1) * rows.shape[0] <= res.shape[0]:
            assert rows.untyped_storage().data_ptr() == res.untyped_storage().data_ptr()

