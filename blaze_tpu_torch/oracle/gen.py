"""MSM test-instance generators, including the reference's tiling trick.

The reference keeps large-size oracle computation cheap by generating only
LARGE_PARAM=256 unique (point, scalar) pairs and tiling them
(`blaze/tests/msm/mod.rs:23-31`, tiling at 92-109), so the expected
result is `(N / 256) * msm(unique) + partial`.  Same trick here.

Points come out as uint32[N, 2, W] canonical 32-bit words and scalars as
uint32[N, Ls] 16-bit limbs — the forms the port's codecs decode to.

`subgroup_msm_instance` is the large-size instance the benchmark and the
chip smoke time: distinct scalars over tiled order-r subgroup points.
`host_vector` and `rand_words` make bulk field words from a seed, on the
host (numpy, in threads) and on a device (torch).
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
    `scalars`: Python ints, or an (n, Ls) array of 16-bit limbs with n a
    multiple of len(upoints) (summed per limb in numpy).

    Reducing the sums mod r is valid only for points of the order-r
    subgroup (ECOracle.random_subgroup_point); ECOracle.random_point's may
    lie outside it on BLS12 curves, whose G1 cofactor is not 1."""
    k = len(upoints)
    if isinstance(scalars, np.ndarray):
        sums = scalars.reshape(-1, k, scalars.shape[-1]).sum(axis=0, dtype=np.int64)
        coeffs = [sum(int(v) << (16 * i) for i, v in enumerate(row)) % spec.fr.p
                  for row in sums]
    else:
        coeffs = [0] * k
        for i, s in enumerate(scalars):
            coeffs[i % k] = (coeffs[i % k] + s) % spec.fr.p
    return ECOracle(spec).msm(upoints, coeffs)


def subgroup_msm_instance(spec: CurveSpec, n: int, seed: int, expected: bool = True):
    """LARGE_PARAM oracle points of the order-r subgroup (point i of the
    MSM is upoints[i % 256]; n a multiple of 256), n distinct scalars drawn
    uniformly from [0, r) as (n, Ls) uint32 16-bit limbs (seeded numpy,
    rejection of words >= r), and the expected affine MSM by
    class_sum_expected (None when `expected` is false)."""
    if n % LARGE_PARAM:
        raise ValueError(f"n = {n} is not a multiple of {LARGE_PARAM}")
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(LARGE_PARAM)]
    fr = spec.fr
    nw = fr.nwords
    r_words = np.frombuffer(fr.p.to_bytes(4 * nw, "little"), dtype="<u4")
    top_mask = (1 << (fr.bits - 32 * (nw - 1))) - 1
    nrng = np.random.default_rng(seed)
    out = np.empty((0, nw), dtype=np.uint32)
    while out.shape[0] < n:
        w = nrng.integers(0, 1 << 32, size=(n, nw), dtype=np.uint64).astype(np.uint32)
        w[:, -1] &= top_mask
        diff = (w != r_words)[:, ::-1]                     # from the top word
        first = nw - 1 - np.argmax(diff, axis=1)
        lt = diff.any(axis=1) & (w[np.arange(n), first] < r_words[first])
        out = np.concatenate([out, w[lt]])[:n]
    # distinct: the top 64 bits already are, but for a chance of ~n^2 2^-64
    top = np.ascontiguousarray(out[:, -2:]).view(np.uint64)[:, 0]
    if np.unique(top).shape[0] != n and np.unique(out, axis=0).shape[0] != n:
        raise AssertionError("scalars not distinct")
    scal = np.ascontiguousarray(out).view("<u2").astype(np.uint32).reshape(n, -1)
    want = class_sum_expected(spec, upoints, scal) if expected else None
    return upoints, scal, want


def _fill_raw(w: np.ndarray, seed: int, parts: int) -> None:
    """Fill w (whole 64-bit words) with the raw output of `parts` numpy
    generators spawned from the seed, in threads (numpy releases the GIL
    there)."""
    from concurrent.futures import ThreadPoolExecutor

    flat = w.reshape(-1).view(np.uint64)
    step = -(-flat.size // parts)

    def fill(i, seq):
        part = flat[i * step:(i + 1) * step]
        part[:] = np.random.PCG64(seq).random_raw(part.size)

    with ThreadPoolExecutor(parts) as ex:
        list(ex.map(fill, range(parts), np.random.SeedSequence(seed).spawn(parts)))


def host_vector(n: int, seed: int, parts: int = 8) -> np.ndarray:
    """(n, 8) uint32 words of random values below 2^254 (below p of every
    8-word field here): the raw 64-bit output of `parts` numpy generators
    spawned from the seed, filled in threads (numpy releases the GIL there),
    the top word masked as bench.py:156-157 does."""
    w = np.empty((n, 8), dtype=np.uint32)
    _fill_raw(w, seed, parts)
    w[:, 7] &= 0x3FFFFFFF
    return w


def field_vector(spec, n: int, seed: int, parts: int = 8) -> np.ndarray:
    """(n, W) uint32 words of random values below 2^(bits-1) < p of the
    field `spec`, at any W (48-byte elements of bls12_377_fq, say): the raw
    output of `parts` numpy generators spawned from the seed, filled in
    threads as host_vector does, the top word masked."""
    W = spec.nwords
    w = np.empty((n, W), dtype=np.uint32)
    _fill_raw(w, seed, parts)
    w[:, W - 1] &= (1 << (spec.bits - 1 - 32 * (W - 1))) - 1
    return w


def rand_words(spec, shape, seed: int, device):
    """int32 words of canonical values below 2^(bits-1) < p of the field
    `spec`, made on `device` from the seed, the word axis at dim 1 (element
    buffers (N, W), lanes-major (R, W, N))."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                      dtype=torch.int32, device=device)
    top = spec.bits - 1 - 32 * (spec.nwords - 1)
    x.select(1, spec.nwords - 1).bitwise_and_((1 << top) - 1)
    return x


def distinct_resident_points(spec: CurveSpec, n: int, seed: int, device,
                             block: int = 1 << 20):
    """(2W, n) resident Montgomery words of n curve points, distinct with
    overwhelming probability, made on `device`: point i is A[i mod a] +
    B[i div a] for two sets of a = 2^ceil(log2(n)/2) oracle points
    (ECOracle.random_point: of order r where the cofactor is 1, as on
    BN254), summed on K3 and normalised to affine (Fermat on K1), `block`
    points at a time."""
    import torch

    from ..curves.kernels import ECKernels
    from ..curves.ops import Curve

    cv, kern = Curve(spec), ECKernels.for_curve(spec)
    W = spec.fq.nwords
    a = 1 << -(-(max(n, 2) - 1).bit_length() // 2)          # a * a >= n
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    pts = [oracle.random_point(rng) for _ in range(2 * a)]
    words = np.ascontiguousarray(points_to_affine_words(spec, pts)).view(np.int32)
    aff = cv.fq.to_mont(torch.from_numpy(words).to(device))            # (2a, 2, W)
    proj = torch.cat([aff, cv.fq.one((2 * a, 1), device)], dim=1)      # (2a, 3, W)
    out = torch.empty((2 * W, n), dtype=torch.int32, device=device)
    for lo in range(0, n, block):
        i = torch.arange(lo, min(lo + block, n), device=device)
        lhs = proj[i % a].reshape(-1, 3 * W).t().contiguous()
        rhs = proj[a + i // a].reshape(-1, 3 * W).t().contiguous()
        s = kern.add(lhs, rhs).t().reshape(-1, 3, W)
        aff = cv.to_affine(cv.fq._cond_sub_p(s.contiguous()))         # (B, 2, W)
        out[:, lo:lo + len(i)] = aff.reshape(-1, 2 * W).t()
    return out
