"""The port's proof pipeline (blaze_tpu_torch.pipeline) against the JAX
package and the oracle, on the CPU (the plain versions of the kernels).

The JAX ProofPipeline's run_batches needs the TPU-only blocked NTT plan, so
the port's run_batches is held to the composition it stands for in
blaze_tpu: NTTPlan on the same canonical coefficients, its first 2^m
values as canonical scalars, MSM(MSMConfig(fused="off")) on the same
points (a) — the two blaze_tpu MSMs compile in a thread while the other
tests run.  The scalars are held to a host NTT in Python ints (b), the
geometric oracle to blaze_tpu's and to the pipeline, and shown wrong off
BLS12-381's order-r subgroup (c); results come one per batch in batch
order, equal to serial runs (d); both input forms are taken and others
refused (e), and so are a wider MSM than NTT, a mesh that is not a
DeviceMesh and a missing card (f).  Inputs are made with seeded numpy and random.Random; everything is
integer arithmetic, so every comparison is exact.
"""
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.msm import MSM as RefMSM, MSMConfig as RefMSMConfig
from blaze_tpu.ntt import NTTPlan
from blaze_tpu.pipeline import geometric_msm_oracle as ref_geometric_msm_oracle
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.fields import words_to_int
from blaze_tpu_torch.msm import points_to_resident
from blaze_tpu_torch.oracle import ECOracle
from blaze_tpu_torch.oracle.gen import points_to_affine_words
from blaze_tpu_torch.pipeline import ProofPipeline, geometric_msm_oracle
from blaze_tpu_torch.utils import DataError, DeviceError

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

NTT_LOGN, MSM_LOGN, WINDOW, UNIQUE = 6, 3, 4, 4


def subgroup_points(spec, seed: int, count: int = UNIQUE):
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    return [oracle.random_subgroup_point(rng) for _ in range(count)]


def resident(cv: Curve, upoints, m: int) -> torch.Tensor:
    """The (2W, m) residency of `upoints` tiled to m points."""
    pts = torch.from_numpy(points_to_affine_words(cv.spec, upoints).view(np.int32))
    return points_to_resident(cv, pts).repeat(1, m // len(upoints)).contiguous()


def coeff_words(fr, seed: int, logn: int = NTT_LOGN) -> np.ndarray:
    """(2^logn, W) uint32 words of random canonical values below 2^(bits-1)."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(1 << logn, fr.nwords),
                                             dtype=np.uint32)
    w[:, -1] &= (1 << (fr.bits - 1 - 32 * (fr.nwords - 1))) - 1
    return w


def unit(fr, rows_values, logn: int = NTT_LOGN) -> torch.Tensor:
    """sum of value * e_row as (2^logn, W) int32 words."""
    w = np.zeros((1 << logn, fr.nwords), dtype=np.uint32)
    for row, v in rows_values:
        w[row] = np.frombuffer(v.to_bytes(4 * fr.nwords, "little"), "<u4")
    return torch.from_numpy(w.view(np.int32))


def affine(cv: Curve, out: torch.Tensor):
    """(3, W) projective Montgomery -> affine Python ints (None: identity)."""
    X, Y, Z = (words_to_int(v) for v in out.numpy().view(np.uint32))
    p = cv.spec.fq.p
    if Z % p == 0:
        return None
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)     # Montgomery's R cancels in X / Z


def jax_composition(name: str, coeffs: np.ndarray, points) -> tuple:
    """What run_batches stands for, in blaze_tpu: NTTPlan on the canonical
    coefficients' limbs, the first 2^m values as canonical scalar limbs,
    MSM(fused="off") over the points; the affine result as ints."""
    spec = REF_CURVES[name]
    rc = RefCurve(spec)
    limbs = jnp.asarray(coeffs.view("<u2").astype(np.uint32))
    scalars = np.asarray(NTTPlan(spec.fr, NTT_LOGN).ntt(limbs))[: len(points)]
    parr = np.ascontiguousarray(points_to_affine_words(CURVES[name], points)).view("<u2")
    pts = rc.fq.to_mont(jnp.asarray(parr.astype(np.uint32).reshape(len(points), 2, -1)))
    out = RefMSM(rc, RefMSMConfig(fused="off"))(pts, jnp.asarray(scalars),
                                                window_bits=WINDOW)
    aff = rc.to_affine(out[None])[0]
    return (rc.fq.to_int(aff[0]), rc.fq.to_int(aff[1]))


JAX_CURVES = ("bn254", "bls12_381")


def jax_case(name: str):
    """(a)'s inputs for one curve: coefficients from seeded numpy and
    UNIQUE subgroup points (tiled to 2^MSM_LOGN where they are used)."""
    i = JAX_CURVES.index(name)
    return coeff_words(CURVES[name].fr, 70 + i), subgroup_points(CURVES[name], 80 + i)


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """blaze_tpu's two compositions (a), compiling in threads from the
    module's first test on, so that the port's runs overlap them."""
    with ThreadPoolExecutor(len(JAX_CURVES)) as ex:
        futures = {}
        for name in JAX_CURVES:
            coeffs, up = jax_case(name)
            futures[name] = ex.submit(jax_composition, name, coeffs,
                                      [up[i % UNIQUE] for i in range(1 << MSM_LOGN)])
        yield futures
        for f in futures.values():
            f.cancel()


@pytest.fixture(scope="module")
def bn254_runs():
    """BN254 at (NTT_LOGN, MSM_LOGN): three batches — e_1, e_3 and random
    coefficients, the middle one also as 16-bit limbs — their serial
    results (pipe.msm on pipe.scalars, one batch at a time) and their run
    through run_batches (the limbs form for batch 1)."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    upoints = jax_case("bn254")[1]
    points = resident(cv, upoints, 1 << MSM_LOGN)
    pipe = ProofPipeline(cv, NTT_LOGN, MSM_LOGN, device="cpu")
    batches = [unit(spec.fr, [(1, 1)]), unit(spec.fr, [(3, 1)]),
               torch.from_numpy(jax_case("bn254")[0].view(np.int32))]
    serial = [pipe.msm(points, pipe.scalars(b), window_bits=WINDOW) for b in batches]
    limbs = torch.from_numpy(batches[1].numpy().view("<u2").astype(np.int32))
    piped = list(pipe.run_batches([batches[0], limbs, batches[2]], points,
                                  window_bits=WINDOW))
    return {"cv": cv, "pipe": pipe, "points": points, "upoints": upoints,
            "batches": batches, "serial": serial, "piped": piped}


# -------------------------------------------------------------- (b) scalars
def _host_ntt(vals, w, p):
    """Recursive Cooley-Tukey on Python ints (scripts/gen_ntt_vectors.py)."""
    n = len(vals)
    if n == 1:
        return vals[:]
    even, odd = _host_ntt(vals[0::2], w * w % p, p), _host_ntt(vals[1::2], w * w % p, p)
    out, wk = [0] * n, 1
    for i in range(n // 2):
        t = wk * odd[i] % p
        out[i], out[i + n // 2] = (even[i] + t) % p, (even[i] - t) % p
        wk = wk * w % p
    return out


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_scalars_are_the_canonical_ntt_of_canonical_coefficients(name):
    """(b) The first 2^m spectral values, as (Ls, 2^m) 16-bit limbs, equal a
    host NTT of the canonical coefficients in Python ints, from words and
    from the reference's limbs alike."""
    spec = CURVES[name]
    fr = spec.fr
    pipe = ProofPipeline(Curve(spec), 8, 6, device="cpu")
    w = coeff_words(fr, 90, logn=8)
    vals = [int.from_bytes(row.tobytes(), "little") for row in w]
    want = _host_ntt(vals, fr.root_of_unity(8), fr.p)[:64]
    words = torch.from_numpy(w.view(np.int32))
    got = pipe.scalars(words)
    assert got.shape == (fr.nlimbs, 64) and got.dtype == torch.int32
    assert [sum(int(v) << (16 * i) for i, v in enumerate(col)) for col in got.t()] == want
    limbs = torch.from_numpy(w.view("<u2").astype(np.int64))
    assert torch.equal(pipe.scalars(limbs), got)


# ------------------------------------------------------------ (c) the oracle
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_geometric_oracle_matches_blaze_tpu_on_subgroup_points(name):
    spec = CURVES[name]
    upoints = subgroup_points(spec, 91)
    r = spec.fr.p
    for k in (1, 3):
        w = pow(spec.fr.root_of_unity(NTT_LOGN), k, r)
        assert geometric_msm_oracle(spec, UNIQUE, 1 << MSM_LOGN, w, upoints) \
            == ref_geometric_msm_oracle(REF_CURVES[name], UNIQUE, 1 << MSM_LOGN, w, upoints)


def test_geometric_oracle_matches_the_pipeline(bn254_runs):
    """(c) e_1 and e_3 give the scalars W^i and (W^3)^i; the pipeline's
    results equal the closed form over the tiled subgroup points."""
    cv, upoints = bn254_runs["cv"], bn254_runs["upoints"]
    fr = cv.spec.fr
    for k, out in ((1, bn254_runs["piped"][0]), (3, bn254_runs["piped"][1])):
        w = pow(fr.root_of_unity(NTT_LOGN), k, fr.p)
        assert affine(cv, out) == geometric_msm_oracle(cv.spec, UNIQUE, 1 << MSM_LOGN, w,
                                                       upoints)


def test_geometric_oracle_needs_subgroup_points():
    """(c) Off the order-r subgroup the closed form is wrong: over
    ECOracle.random_point's BLS12-381 points it differs from the MSM of
    the tiled points with scalars W^i, which it equals on subgroup
    points."""
    spec = CURVES["bls12_381"]
    oracle = ECOracle(spec)
    rng = random.Random(92)
    r, m = spec.fr.p, 1 << MSM_LOGN
    w = spec.fr.root_of_unity(NTT_LOGN)
    for sample, holds in ((oracle.random_point, False), (oracle.random_subgroup_point, True)):
        upoints = [sample(rng) for _ in range(UNIQUE)]
        truth = oracle.msm([upoints[i % UNIQUE] for i in range(m)],
                           [pow(w, i, r) for i in range(m)])
        assert (geometric_msm_oracle(spec, UNIQUE, m, w, upoints) == truth) == holds


# ---------------------------------------------------------- (d) batch order
@pytest.mark.parametrize("count", [1, 2, 3])
def test_results_come_in_batch_order_equal_to_serial_runs(bn254_runs, count):
    """(d) One result per batch, in batch order, each equal to the batch's
    serial result; the three batches' results differ, so a pipeline that
    mixed up or reused batches would fail (the 3-batch run gives batch 1 as
    16-bit limbs)."""
    serial = bn254_runs["serial"]
    assert len({tuple(s.reshape(-1).tolist()) for s in serial}) == 3
    if count == 3:
        got = bn254_runs["piped"]
    else:
        got = list(bn254_runs["pipe"].run_batches(bn254_runs["batches"][:count],
                                                  bn254_runs["points"], window_bits=WINDOW))
    assert len(got) == count
    for g, s in zip(got, serial):
        assert torch.equal(g, s)


# ------------------------------------------------------ (e) the input forms
def test_input_forms_and_refusals():
    """(e) Words (2^n, W) int32 and limbs (2^n, L) int32/int64 give the same
    scalars; other shapes, types, devices and out-of-range limbs raise
    DataError, as do points of another shape — before any batch runs."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    fr = spec.fr
    pipe = ProofPipeline(cv, 4, 2, device="cpu")
    w = torch.from_numpy(coeff_words(fr, 93, logn=4).view(np.int32))
    limbs = torch.from_numpy(w.numpy().view("<u2").astype(np.int32))
    assert torch.equal(pipe.scalars(limbs), pipe.scalars(w))
    assert torch.equal(pipe.scalars(limbs.long()), pipe.scalars(w))
    too_big = limbs.clone()
    too_big[3, 5] = 1 << 16
    points = resident(cv, subgroup_points(spec, 94), 4)
    for bad in (w[:8], w[:, :4], w.reshape(8, 16)[:, :12], w.long(), limbs.short(),
                too_big, w.numpy(), w.reshape(-1)):
        with pytest.raises(DataError):
            pipe.scalars(bad)
        with pytest.raises(DataError):
            next(pipe.run_batches([bad], points))
    for bad in (points[:, :2], points.long(), points.t()):
        with pytest.raises(DataError):
            next(pipe.run_batches([w], bad))
    assert list(pipe.run_batches([], points)) == []


# ------------------------------------------------- (f) what it refuses to be
def test_refuses_a_wider_msm_a_mesh_and_a_missing_card():
    """(f) msm_logn > ntt_logn and a mesh that is not a torch DeviceMesh
    raise ValueError (a DeviceMesh runs run_dist: tests/test_torch_dist.py);
    without a card the default construction raises."""
    cv = Curve(CURVES["bn254"])
    with pytest.raises(ValueError):
        ProofPipeline(cv, 4, 5, device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        ProofPipeline(cv, 4, 2, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            ProofPipeline(cv, 4, 2)


# ------------------------------------------------- (a) against blaze_tpu
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_run_batches_matches_blaze_tpu_composition(name, jax_reference, bn254_runs):
    """(a) run_batches on the CPU equals blaze_tpu's NTTPlan -> scalars ->
    MSM(fused="off") on the same coefficients and points, as affine ints."""
    if name == "bn254":
        cv, out = bn254_runs["cv"], bn254_runs["piped"][2]
    else:
        spec = CURVES[name]
        cv = Curve(spec)
        coeffs, upoints = jax_case(name)
        pipe = ProofPipeline(cv, NTT_LOGN, MSM_LOGN, device="cpu")
        (out,) = pipe.run_batches([torch.from_numpy(coeffs.view(np.int32))],
                                  resident(cv, upoints, 1 << MSM_LOGN), window_bits=WINDOW)
    assert affine(cv, out) == jax_reference[name].result(timeout=600)
