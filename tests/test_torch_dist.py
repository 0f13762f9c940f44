"""The port's sharded paths (blaze_tpu_torch.dist, ProofPipeline.run_dist) and
its four-step NTT against the JAX package, on the CPU over gloo.

Multi-rank cases run in spawned processes (tests/torch_dist_worker.py): a
group of 4 ranks runs the 1-D meshes {dp: 4} and {sp: 4} (D = 4) and the
2-D mesh {dp: 2, sp: 2}, and a group of 2 ranks the meshes {dp: 2} and
{sp: 2}; each group meets through a FileStore under tmp_path and is killed
if it has not finished in 120 s, so a hung collective fails its tests
instead of the suite.  D = 1 runs in this process on a group of one
(make_mesh's HashStore), destroyed when the module is done.

The JAX package's dist/ code needs 8 virtual devices and a subprocess of
its own (tests/test_dist.py), and tests/test_dist.py already holds it to
the oracle and to single-device results.  The port's sharded paths are held
instead to blaze_tpu's single-device NTTPlan, its pure-Python oracle
(random_msm_instance, tiled_msm_instance, ECOracle) and the committed
golden pair tests/fixtures/ntt_bls12_381_fr_2e8.*, on the cases of
tests/dist_cases.py.  Everything is integer arithmetic: every comparison is
exact.
"""
import random
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES
from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu.ntt import NTTPlan as RefNTTPlan
from blaze_tpu.oracle import ECOracle as RefECOracle, random_msm_instance, tiled_msm_instance
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.dist import DistributedMSM, DistributedNTT, make_mesh
from blaze_tpu_torch.fields import FIELDS, Field, int_to_words
from blaze_tpu_torch.ntt import FourStepNTT, FusedNTT, NTTPlan
from blaze_tpu_torch.pipeline import ProofPipeline
from torch_dist_worker import CASES, join_ranks, start_ranks

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
NTT_FIELD, NTT_LOGN, NTT_LOGN1 = "bls12_381_fr", 8, 4
WINDOW = 4


def words(limbs: np.ndarray) -> np.ndarray:
    """(..., L) 16-bit limbs (the JAX package's form) -> (..., W) uint32 words."""
    return np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32).astype("<u2")).view("<u4")


def limbs(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> (..., L) 16-bit limbs as uint32."""
    return np.ascontiguousarray(w, dtype=np.uint32).view("<u2").astype(np.uint32)


def affine(spec, res: np.ndarray):
    """(3, W) projective Montgomery words -> affine ints (z-normalisation
    divides Montgomery's R out)."""
    p = spec.fq.p
    X, Y, Z = (sum(int(v) << (32 * i) for i, v in enumerate(row)) for row in res)
    zi = pow(Z, -1, p)
    return X * zi % p, Y * zi % p


def mont_words(field: str, values) -> np.ndarray:
    """Python ints -> (len, W) uint32 Montgomery words of the port's field."""
    spec = FIELDS[field]
    return np.stack([int_to_words(v * spec.r % spec.p, spec.nwords) for v in values])


# ------------------------------------------------------------------ inputs
def msm_case(seed: int, n: int, mesh: dict, bits8: bool = False) -> dict:
    """blaze_tpu.oracle.random_msm_instance on bn254 as a worker input, its
    expected affine point beside it (with bits8, of the scalars masked to
    their low 8 bits: tests/dist_cases.py:58-86)."""
    spec = REF_CURVES["bn254"]
    pts, scal, expected, dbg = random_msm_instance(spec, n, seed=seed)
    case = {"kind": "msm", "curve": "bn254", "mesh": mesh, "points": words(pts),
            "window_bits": WINDOW}
    if bits8:
        scal = np.asarray(scal).copy()
        scal[:, 0] &= 0xFF
        scal[:, 1:] = 0
        expected = RefECOracle(spec).msm(dbg["points"], [int(s[0]) for s in scal])
        case["scalar_bits"] = 8
    case["scalars"] = np.asarray(scal, dtype=np.uint32)
    return case, expected


def ntt_case(mesh: dict) -> dict:
    raw = (FIXDIR / f"ntt_{NTT_FIELD}_2e{NTT_LOGN}.in").read_bytes()
    x = np.frombuffer(raw, dtype="<u4").reshape(1 << NTT_LOGN, 8).copy()
    return {"kind": "ntt", "field": NTT_FIELD, "logn": NTT_LOGN, "logn1": NTT_LOGN1,
            "mesh": mesh, "x": x}


def run_dist_case(mesh: dict, masked: bool) -> tuple:
    """tests/dist_cases.py:104-142 on bn254 at (2^6, 2^5): e_1 in Montgomery
    form, so the spectral values are W^i and the scalars W^i (with
    `masked`, their low 8 bits: the 8-bit mask of the JAX dry run)."""
    spec = REF_CURVES["bn254"]
    ntt_logn, msm_logn = 6, 5
    pts, _, _, dbg = tiled_msm_instance(spec, 1 << msm_logn, seed=77)
    ints = [0] * (1 << ntt_logn)
    ints[1] = 1
    case = {"kind": "run_dist", "curve": "bn254", "mesh": mesh, "ntt_logn": ntt_logn,
            "msm_logn": msm_logn, "points": words(pts), "window_bits": WINDOW,
            "coeffs": mont_words(spec.fr.name, ints)}
    w, p = spec.fr.root_of_unity(ntt_logn), spec.fr.p
    scalars = [pow(w, i, p) for i in range(1 << msm_logn)]
    if masked:
        mask = np.zeros(spec.fr.nlimbs, np.uint32)
        mask[0] = 0xFF                                   # 8 live scalar bits
        case.update(mask=mask, scalar_bits=8)
        scalars = [s & 0xFF for s in scalars]
    return case, RefECOracle(spec).msm(dbg["points"][:1 << msm_logn], scalars)


MSM_FULL = dict(seed=60, n=64)


def cases_for(world: int) -> tuple:
    """The worker inputs of one gloo group and the expected points."""
    cases, want = {}, {}
    d = {"dp": world}
    cases["msm"], want["msm"] = msm_case(mesh=d, **MSM_FULL)
    cases["ntt"] = ntt_case({"sp": world})
    if world == 4:
        two_d = {"dp": 2, "sp": 2}
        cases["msm_2d"], want["msm_2d"] = msm_case(62, 32, two_d)
        cases["msm_bits8"], want["msm_bits8"] = msm_case(63, 64, d, bits8=True)
        cases["ntt_2d"] = ntt_case(two_d)
        cases["run_dist_2d"], want["run_dist_2d"] = run_dist_case(two_d, masked=True)
        cases["ragged"] = {"kind": "ragged", "curve": "bn254", "mesh": d}
    return cases, want


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{D: (every rank's outputs, expected points)} for D = 2 and 4 (one
    spawned gloo group each) and D = 1 (this process, a group of one,
    while the two groups run)."""
    started = {}
    for world in (4, 2):
        cases, want = cases_for(world)
        started[world] = (start_ranks(world, cases, tmp_path_factory.mktemp(f"gloo{world}")),
                          want)
    cases, want = cases_for(1)
    cases["run_dist_full"], want["run_dist_full"] = run_dist_case({"dp": 1, "sp": 1},
                                                                  masked=False)
    try:
        got = {name: CASES[c["kind"]](c) for name, c in cases.items()}
    finally:
        dist.destroy_process_group()
    out = {world: (join_ranks(group), want) for world, (group, want) in started.items()}
    out[1] = ([got], want)
    return out


@pytest.fixture(scope="module")
def ref_ntt():
    """blaze_tpu's single-device NTTPlan over the golden input (limbs out),
    and the golden output, both as (n, W) uint32 words."""
    x = ntt_case({})["x"]
    plan = RefNTTPlan(REF_FIELDS[NTT_FIELD], NTT_LOGN)
    got = words(np.asarray(plan.ntt(jnp.asarray(limbs(x)))))
    golden = np.frombuffer((FIXDIR / f"ntt_{NTT_FIELD}_2e{NTT_LOGN}.out").read_bytes(),
                           dtype="<u4").reshape(x.shape)
    return x, got, golden


# ------------------------------------------------------------------ the MSM
@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_msm_matches_oracle(groups, D):
    """DistributedMSM on {dp: D}, bn254, n = 64, window 4: every rank's
    result equals blaze_tpu.oracle.random_msm_instance's expected point."""
    outs, want = groups[D]
    assert [affine(CURVES["bn254"], o["msm"]) for o in outs] == [want["msm"]] * len(outs)


def test_distributed_msm_on_a_2d_mesh(groups):
    """The dp axis of {dp: 2, sp: 2} (the JAX dry run's layout): ranks with
    one dp coordinate share a block, the sp ranks replicate it."""
    outs, want = groups[4]
    assert [affine(CURVES["bn254"], o["msm_2d"]) for o in outs] == [want["msm_2d"]] * 4


def test_distributed_msm_scalar_bits(groups):
    """scalar_bits=8 with the scalars masked to 8 bits, D = 4, against the
    oracle MSM of the masked scalars."""
    outs, want = groups[4]
    assert [affine(CURVES["bn254"], o["msm_bits8"]) for o in outs] == [want["msm_bits8"]] * 4


def test_distributed_msm_refuses_a_ragged_split(groups):
    """n % D != 0 raises ValueError on every rank (before any collective)."""
    outs, _ = groups[4]
    assert all("not divisible" in o["ragged"] for o in outs)


# ------------------------------------------------------------------ the NTT
@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_ntt_matches_jax_and_goldens(groups, ref_ntt, D):
    """DistributedNTT at logn 8, logn1 4 on {sp: D}: spectral_to_natural on
    every rank equals blaze_tpu's NTTPlan(spec, 8).ntt and the golden
    output, and intt comes back to the input."""
    x, ref, golden = ref_ntt
    assert np.array_equal(ref, golden)
    outs, _ = groups[D]
    for o in outs:
        assert np.array_equal(o["ntt"]["natural"], ref)
        assert np.array_equal(o["ntt"]["back"], x)


@pytest.mark.parametrize("D,case", [(1, "ntt"), (2, "ntt"), (4, "ntt"), (4, "ntt_2d")])
def test_distributed_ntt_k_matrix_layout(groups, ref_ntt, D, case):
    """The ranks' shards, in rank order along k1, are the JAX package's
    (n1, n2) k-matrix (ntt_dist.py:160-170): out[k1, k2] = X[k1 + n1*k2].
    On {dp: 2, sp: 2} the sp axis has D = 2 and the dp ranks replicate."""
    _, ref, _ = ref_ntt
    outs, _ = groups[D]
    shards = [o[case]["shard"] for o in outs]
    n1, n2 = 1 << NTT_LOGN1, 1 << (NTT_LOGN - NTT_LOGN1)
    d = 2 if case == "ntt_2d" else D
    kmat = np.concatenate(shards[-d:] if case == "ntt_2d" else shards)   # ranks (1, 0), (1, 1)
    assert kmat.shape == (n1, n2, 8)
    k1, k2 = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    assert np.array_equal(kmat, ref[k1 + n1 * k2])
    if case == "ntt_2d":
        assert np.array_equal(np.concatenate(shards[:2]), kmat)


# ----------------------------------------------------------------- run_dist
def test_run_dist_on_a_2d_mesh(groups):
    """ProofPipeline(mesh={dp: 2, sp: 2}).run_dist at (2^6, 2^5), e_1 with
    the 8-bit mask (tests/dist_cases.py:104-142), against the oracle."""
    outs, want = groups[4]
    assert [affine(CURVES["bn254"], o["run_dist_2d"]) for o in outs] == \
        [want["run_dist_2d"]] * 4


def test_run_dist_full_width_on_one_rank(groups):
    """The same composition at D = 1 with full-width scalars W^i."""
    outs, want = groups[1]
    assert affine(CURVES["bn254"], outs[0]["run_dist_full"]) == want["run_dist_full"]


def test_mesh_pipeline_refuses_the_other_path():
    """run_batches on a mesh pipeline and run_dist without a mesh raise, as
    in the JAX package; so does a mesh that is not a DeviceMesh."""
    cv = Curve(CURVES["bn254"])
    try:
        pipe = ProofPipeline(cv, 4, 2, mesh=make_mesh({"dp": 1, "sp": 1}, device_type="cpu"))
        with pytest.raises(ValueError, match="run_dist"):
            next(pipe.run_batches([], None))
        with pytest.raises(ValueError, match="run_dist"):
            pipe.scalars(torch.zeros((16, 8), dtype=torch.int32))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="no mesh"):
        ProofPipeline(cv, 4, 2, device="cpu").run_dist(None, None)


# ------------------------------------------------------- the four-step NTT
@pytest.fixture(scope="module")
def ref_batch(ref_ntt):
    """A (2, n, W) batch (the golden input and its roll by one), blaze_tpu's
    NTTPlan.ntt of it, and blaze_tpu's NTTPlan.intt of that."""
    x, _, _ = ref_ntt
    x2 = np.stack([x, np.roll(x, 1, axis=0)])
    plan = RefNTTPlan(REF_FIELDS[NTT_FIELD], NTT_LOGN)
    ref2 = words(np.asarray(plan.ntt(jnp.asarray(limbs(x2)))))
    return x2, ref2, words(np.asarray(plan.intt(jnp.asarray(limbs(ref2)))))


@pytest.mark.parametrize("cls", [FourStepNTT, NTTPlan])
def test_four_step_and_plan_match_jax_both_ways(ref_ntt, ref_batch, cls):
    """FourStepNTT (logn1 4) and NTTPlan at logn 8 on a (2, n, W) batch
    equal blaze_tpu's NTTPlan forward, and their inverses come back, as
    blaze_tpu's inverse does."""
    _, ref, _ = ref_ntt
    x2, ref2, ref_back = ref_batch
    assert np.array_equal(ref2[0], ref) and np.array_equal(ref_back, x2)
    spec = FIELDS[NTT_FIELD]
    plan = (FourStepNTT(spec, NTT_LOGN, NTT_LOGN1, device="cpu") if cls is FourStepNTT
            else NTTPlan(spec, NTT_LOGN, device="cpu"))
    got = plan.ntt(torch.from_numpy(x2.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), ref2)
    back = plan.intt(got)
    assert np.array_equal(back.numpy().view(np.uint32), x2)


@pytest.mark.parametrize("minor", [False, True])
def test_batched_fused_ntt_matches_separate_plans(minor):
    """FusedNTT.ntt_batch / intt_batch over B = 4 transforms of 2^6 at klog 3
    (two levels), read through a stride (element stride 8, transform
    stride 1: the four-step's columns), equal B separate plans' ntt and
    intt, laid out as (B, n) or (n, B) rows."""
    spec = FIELDS[NTT_FIELD]
    B, logn = 4, 6
    n = 1 << logn
    plan = FusedNTT(spec, logn, klog=3, device="cpu")
    rng = np.random.default_rng(7)
    w = rng.integers(0, 1 << 32, size=(n * 2 * B, 8), dtype=np.uint32)
    w[:, -1] &= (1 << 30) - 1
    x = torch.from_numpy(w.view(np.int32))
    for inverse in (False, True):
        run = plan.intt_batch if inverse else plan.ntt_batch
        got = run(x, B, stride=2 * B, batch_stride=1, minor=minor)
        got = got.view(n, B, 8).transpose(0, 1) if minor else got.view(B, n, 8)
        for b in range(B):
            col = x[torch.arange(n) * 2 * B + b].contiguous()
            want = plan.intt(col) if inverse else plan.ntt(col)
            assert torch.equal(got[b], want)


def test_power_matrix_matches_jax():
    """Field.power_matrix(bases, 8) over 4 bases equals blaze_tpu's."""
    spec = FIELDS[NTT_FIELD]
    rnd = random.Random(3)
    bases = mont_words(NTT_FIELD, [rnd.randrange(spec.p) for _ in range(4)])
    got = Field(spec).power_matrix(torch.from_numpy(bases.view(np.int32)), 8)
    ref = RefField(REF_FIELDS[NTT_FIELD]).power_matrix(jnp.asarray(limbs(bases)), 8)
    assert got.shape == (4, 8, 8)
    assert np.array_equal(got.numpy().view(np.uint32), words(np.asarray(ref)))


@pytest.mark.parametrize("logn1", [10, 1])
def test_four_step_with_two_level_sub_plans(logn1):
    """FourStepNTT at logn 11 with a 2^10 sub-plan of two levels (parts [5,
    5]) on either side, so the batched sub-plans run K9 between their
    levels as the 2^27 plan's do: equal to FusedNTT (held against the JAX
    package in tests/test_torch_ntt.py), and back."""
    spec = FIELDS[NTT_FIELD]
    rng = np.random.default_rng(logn1)
    w = rng.integers(0, 1 << 32, size=(1 << 11, 8), dtype=np.uint32)
    w[:, -1] &= (1 << 30) - 1
    x = torch.from_numpy(w.view(np.int32))
    plan = FourStepNTT(spec, 11, logn1, device="cpu")
    assert [len(plan.plan1.parts), len(plan.plan2.parts)] == ([2, 1] if logn1 == 10 else [1, 2])
    got = plan.ntt(x)
    assert torch.equal(got, FusedNTT(spec, 11, device="cpu").ntt(x))
    assert torch.equal(plan.intt(got), x)
