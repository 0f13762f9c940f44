"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

K1-K6 against their plain PyTorch versions on the same device inputs,
exact, on all three curves (K2-K5 also at ragged lane counts, K6 at
ragged window counts), and K7-K10 (with the multi-p REDC twin) on the three
scalar fields (K7 through strided and transposed maps and at the 2^27
plan's levels, K8's element rows at ragged lengths, in place and out of
place), K10 also over the 12-word base fields and at t = 17; the MSM client on the card against the oracle with
distinct scalars; the NTT client on the card against every committed golden
pair, and at 2^16 (the K8 twiddle fallback: K7 twice and K8 once, nothing
else on the card) against a host NTT in Python ints with an inverse
roundtrip; the Poseidon client at height 3, staged, streamed and TREE_D,
against the oracle; the proof pipeline at (2^12, 2^10) against its CPU
run; K7 and K9 at batched maps (FusedNTT.ntt_batch) against their plain
versions, and the sharded paths over NCCL on a mesh of one rank
(DistributedMSM against the plain MSM and the oracle, DistributedNTT
against the CPU four-step and FusedNTT, run_dist against its geometric
oracle).  chip_smoke.py runs the same checks at the main path's sizes.
"""
import random
from pathlib import Path

import numpy as np

import pytest
import torch

from blaze_tpu_torch.curves import (
    CURVES,
    Curve,
    decode_projective_result,
    encode_affine_points,
    encode_scalars,
)
from blaze_tpu_torch.curves.kernels import ECKernels
from blaze_tpu_torch import _build
from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.fields.montmul import mont_mul, mont_mul_plain
from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs
from blaze_tpu_torch.hash import (
    PoseidonKernels,
    TreeMode,
    generate_params,
    num_tree_nodes,
    params_from_reference,
)
from blaze_tpu_torch.hash.kernels import sum_products, sum_products_plain
from blaze_tpu_torch.msm import points_to_resident
from blaze_tpu_torch.ntt import FourStepNTT, FusedNTT, NTTKernels
from blaze_tpu_torch.ntt.fused import plan_levels
from blaze_tpu_torch.ntt.kernels import TileMap
from blaze_tpu_torch.oracle.poseidon_ref import merkle_tree_ref, poseidon_hash_ref
from blaze_tpu_torch.pipeline import ProofPipeline
from blaze_tpu_torch.runtime import (
    MSMClient,
    MSMInit,
    MSMInput,
    MSMParams,
    NTTClient,
    NTTInit,
    NTTInput,
    PoseidonClient,
    PoseidonInitializeParameters,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CURVES))
def test_kernels_match_plain_versions(dev, name):
    spec = CURVES[name]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(1)
    pts = [oracle.random_point(rng) for _ in range(4 * 256)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=dev),
                       cv.fq.from_int([y for _, y in pts], device=dev)], dim=1)
    rows = aff.reshape(4, 256, -1).permute(0, 2, 1).contiguous()
    sgn = torch.randint(0, 2, (4, 1, 256), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    rows_s = torch.cat([rows, sgn], dim=1).contiguous()
    a = aff.reshape(-1, spec.fq.nwords).contiguous()
    b = a.flip(0).contiguous()
    assert torch.equal(mont_mul(spec.fq, a, b), mont_mul_plain(spec.fq, a, b))
    for r in (rows, rows_s):
        got, want = k.scan_mixed(r), k.scan_mixed_plain(r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    em = got[0]
    p, q = em[1].contiguous(), em[3].contiguous()
    assert torch.equal(k.add(p, q), k.add_plain(p, q))
    assert torch.equal(k.reduce_cols(em), k.reduce_cols_plain(em))
    assert torch.equal(k.dbl_n(p, 5), k.dbl_n_plain(p, 5))
    ws = p[:, :6].contiguous()
    assert torch.equal(k.fold_horner(ws, 5), k.fold_horner_plain(ws, 5))


@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_kernels_match_plain_at_ragged_shapes(dev, name, B):
    """K2 (unsigned and signed, C = 1 and 4) and K4 (C = 1, and 4 rows that
    hold identities) at ragged lane counts, exact."""
    spec = CURVES[name]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(B)
    pts = [oracle.random_point(rng) for _ in range(4 * B)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=dev),
                       cv.fq.from_int([y for _, y in pts], device=dev)], dim=1)
    rows = aff.reshape(4, B, -1).permute(0, 2, 1).contiguous()
    sgn = torch.randint(0, 2, (4, 1, B), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(B)).to(dev)
    rows_s = torch.cat([rows, sgn], dim=1).contiguous()
    for r in (rows, rows_s):
        for C in (1, 4):
            x = r[:C].contiguous()
            got, want = k.scan_mixed(x), k.scan_mixed_plain(x)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (C, r.shape)
    em = k.scan_mixed_plain(rows)[0]
    ident = cv.identity(device=dev).reshape(-1, 1)
    em[1, :, ::3] = ident
    em[:, :, -1:] = ident[None]
    for C in (1, 4):
        x = em[:C].contiguous()
        assert torch.equal(k.reduce_cols(x), k.reduce_cols_plain(x)), C


@pytest.mark.parametrize("name", sorted(CURVES))
def test_fold_and_doublings_match_plain_at_ragged_shapes(dev, name):
    """K5 at B = 1, 33, 1000 (k 15 and 16) and K6 at Wn = 1, 2, 16, 20 (and
    128 on the 12-word curves, past 48 KB of shared memory), identity
    points among the inputs, exact."""
    spec = CURVES[name]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(6)
    pts = [oracle.random_point(rng) for _ in range(2 * 1000)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=dev),
                       cv.fq.from_int([y for _, y in pts], device=dev)], dim=1)
    rows = aff.reshape(2, 1000, -1).permute(0, 2, 1).contiguous()
    lazy = k.scan_mixed(rows)[0][1]                               # (3W, 1000)
    lazy[:, 1::7] = cv.identity(device=dev).reshape(-1, 1)
    for B in (1, 33, 1000):
        x = lazy[:, :B].contiguous()
        for kd in (15, 16):
            assert torch.equal(k.dbl_n(x, kd), k.dbl_n_plain(x, kd)), (B, kd)
    shapes = [(1, 13), (2, 13), (16, 16), (20, 13)]
    if spec.fq.nwords == 12:
        shapes.append((128, 2))
    for Wn, c in shapes:
        ws = lazy[:, 40:40 + Wn].contiguous()
        assert torch.equal(k.fold_horner(ws, c), k.fold_horner_plain(ws, c)), (Wn, c)


def test_client_on_card_matches_oracle(dev):
    spec = CURVES["bls12_381"]
    oracle = ECOracle(spec)
    rng = random.Random(3)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    n = 4096
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    praw = encode_affine_points(points_to_affine_words(spec, upoints * (n // 16)), spec)
    client = MSMClient(MSMInit(curve="bls12_381"))
    assert client.ctx.device.type == "cuda"
    client.initialize(MSMParams(nof_elements=n))
    client.set_data(MSMInput(scalars=encode_scalars(scalars_to_limbs(spec, scalars), spec),
                             points=praw))
    client.start_process()
    X, Y, Z = (words_to_int(v)
               for v in decode_projective_result(client.result().result, spec))
    p = spec.fq.p
    zi = pow(Z, -1, p)
    assert (X * zi % p, Y * zi % p) == class_sum_expected(spec, upoints, scalars)


def canonical(spec, shape, seed, dev):
    """int32 words, word axis 1, of random values below 2^(bits-1) < p."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)
    w[:, -1] &= (1 << (spec.bits - 1 - 32 * (spec.nwords - 1))) - 1
    return torch.from_numpy(w.view(np.int32)).to(dev)


def ntt_layouts(K: int, B: int):
    """(input rows, xmap, output rows, omap, in place) of K7's layouts:
    (K, B) rows out of and in place, a strided input into a transposed
    output, a transposed buffer in place."""
    rows, tr = TileMap.rows(B), TileMap.lanes_at(1, K.bit_length() - 1)
    return [(K * B, rows, K * B, rows, False), (K * B, rows, K * B, rows, True),
            (K * (B + 3), TileMap.lanes_at(B + 3), K * B, tr, False),
            (K * B, tr, K * B, tr, True)]


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr"])
def test_ntt_kernels_match_plain_versions(dev, field):
    spec = FIELDS[field]
    k, W = NTTKernels.for_spec(spec), spec.nwords
    for K, B in ((2, 100), (8, 257), (64, 45), (128, 21), (256, 11), (512, 37)):
        pack = canonical(spec, (K, W), K + 1, dev)
        for i, (nx, xmap, no, omap, in_place) in enumerate(ntt_layouts(K, B)):
            x = canonical(spec, (nx, W), K + i, dev)
            want = k.ntt_base_plain(x, pack, B, xmap, out=torch.zeros_like(x[:no]), omap=omap)
            out = x.clone() if in_place else torch.zeros_like(x[:no])
            got = k.ntt_base(out if in_place else x, pack, B, xmap, out=out, omap=omap)
            assert got is out and torch.equal(out, want), (K, B, i)
    a, b, c = (canonical(spec, (4, W, 300), 10 + i, dev) for i in range(3))
    assert torch.equal(k.mul_lm(a, b), k.mul_lm_plain(a, b))
    assert torch.equal(k.mul_lm(a, b, c), k.mul_lm_plain(a, b, c))
    for A, J, S, B in ((8, 4, 32, 1), (8, 4, 8, 16)):
        y = canonical(spec, (A * J * S * B, W), 20, dev)
        t1 = canonical(spec, (A * J, W), 21, dev).reshape(A, J, W)
        t2 = canonical(spec, (A * S, W), 22, dev).reshape(A, S, W)
        # v in the row's low bits, j above the b bits (a plan's level-0 order)
        lb, lc = B.bit_length() - 1, (J * S).bit_length() - 1
        vshift, fields = 0, ((A.bit_length() - 1 + lb, lc, 0),)
        want = k.twiddle_mul_plain(y, t1, t2, vshift, fields)
        assert torch.equal(k.twiddle_mul(y, t1, t2, vshift, fields), want)
        assert torch.equal(k.twiddle_mul(y, t1, t2, vshift, fields, out=y), want)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_ntt_base_at_the_2e27_levels(dev, depth):
    """K7 through each level's maps of the 2^27 plan (parts 9, 9, 9: level
    0 out of place into the reversed lane digits, levels 1 and 2 in place)
    over the whole 4 GiB buffer, held to the plain version on its first
    2^10 lanes."""
    spec = FIELDS["bls12_381_fr"]
    k, W = NTTKernels.for_spec(spec), spec.nwords
    lv = plan_levels([9, 9, 9])[depth]
    K, cut = 1 << lv.a, 1 << 10
    pack = canonical(spec, (K, W), 3, dev)
    x = canonical(spec, (1 << 27, W), depth, dev)
    in_place = lv.xmap == lv.omap
    out = x.clone() if in_place else torch.zeros_like(x)
    k.ntt_base(out if in_place else x, pack, lv.lanes, lv.xmap, out=out, omap=lv.omap)
    want = k.ntt_base_plain(x, pack, cut, lv.xmap, out=torch.zeros_like(x), omap=lv.omap)
    rows = lv.omap.offsets(K, cut, dev).reshape(-1)
    assert torch.equal(out[rows], want[rows])


@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_ec_add_matches_plain_at_ragged_shapes(dev, name, B):
    """K3 at ragged lane counts, exact: distinct lazy points, p = q, and
    identities as either operand."""
    spec = CURVES[name]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(B + 7)
    pts = [oracle.random_point(rng) for _ in range(2 * B)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=dev),
                       cv.fq.from_int([y for _, y in pts], device=dev)], dim=1)
    em = k.scan_mixed(aff.reshape(2, B, -1).permute(0, 2, 1).contiguous())[0]
    ident = cv.identity(device=dev).reshape(-1, 1)
    p, q = em[0].clone(), em[1].clone()
    p[:, ::3] = ident
    q[:, 1::4] = ident
    q[:, 2::5] = p[:, 2::5]
    for a, b in ((p, q), (q, p), (p, p)):
        assert torch.equal(k.add(a, b), k.add_plain(a, b))


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


def _run(client, data):
    client.set_data(NTTInput(data=data))
    client.start_process()
    client.wait_result()
    return client.result()


def test_ntt_client_on_card_matches_goldens_and_host_ntt(dev):
    fixtures = sorted((Path(__file__).parent / "fixtures").glob("ntt_*_2e*.in"))
    assert fixtures
    for inf in fixtures:
        field, logn = inf.stem[4:].rsplit("_2e", 1)
        init = NTTInit(field=field, logn=int(logn))
        raw, want = inf.read_bytes(), inf.with_suffix(".out").read_bytes()
        assert _run(NTTClient(init), raw) == want
        assert _run(NTTClient(init, inverse=True), want) == raw

    spec, logn = FIELDS["bls12_381_fr"], 16
    rng = random.Random(4)
    vals = [rng.randrange(spec.p) for _ in range(1 << logn)]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    _build.reset_launches()
    client = NTTClient(NTTInit(field=spec.name, logn=logn))
    assert client.ctx.device.type == "cuda"
    out = _run(client, raw)
    assert _build.LAUNCHES["ntt_base"] == 2 and _build.LAUNCHES["mul_lm"] == 1
    want = _host_ntt(vals, spec.root_of_unity(logn), spec.p)
    assert out == b"".join(v.to_bytes(32, "little") for v in want)
    assert _run(NTTClient(NTTInit(field=spec.name, logn=logn), inverse=True), out) == raw


def singular_block(params):
    """`params` with row 2 of the MDS copied from row 1 past column 0: the
    lower-right block is singular, so K10 keeps the dense rounds."""
    mds = [list(row) for row in params.mds]
    mds[2][1:] = mds[1][1:]
    return params_from_reference(params.spec, params.t, params.alpha, params.r_f, params.r_p,
                                 params.round_constants, mds)


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr"])
def test_poseidon_kernel_matches_plain_version(dev, field):
    """The sparse schedule and (the singular-block instance) the dense
    rounds, at t = 3, 9 and 12."""
    spec = FIELDS[field]
    W = spec.nwords
    pm1 = torch.from_numpy(int_to_words(spec.p - 1, W).view(np.int32)).to(dev)
    for t in (3, 9, 12):
        params = generate_params(spec, t)
        for k in (PoseidonKernels.for_params(params),
                  PoseidonKernels.for_params(singular_block(params))):
            x = canonical(spec, (t, W, 300), t, dev)
            x[:, :, 0] = pm1                             # a canonical state near p
            for conv in (False, True):
                want = k.permute_lm_plain(x, conv)
                assert torch.equal(k.permute_lm(x, convert_in=conv), want)
                y = x.clone()
                k.permute_lm(y, convert_in=conv, out=y)  # in place
                assert torch.equal(y, want)
        if t == 3:
            continue
        a, c = canonical(spec, (t, W, 64), 2 * t, dev), canonical(spec, (t, W, 64), 3 * t, dev)
        a[:, :, 0] = c[:, :, 0] = pm1                    # T = t (p-1)^2
        assert torch.equal(sum_products(spec, a, c), sum_products_plain(spec, a, c))


@pytest.mark.parametrize("field,t", [("bls12_381_fq", 3), ("bls12_377_fq", 5),
                                     ("bn254_fr", 17), ("bls12_381_fq", 17)])
def test_poseidon_kernel_at_12_words_and_t17(dev, field, t):
    """K10 and the multi-p REDC twin over the 12-word base fields and at
    t = 17, the widest state of the reference's round table."""
    spec = FIELDS[field]
    W = spec.nwords
    pm1 = torch.from_numpy(int_to_words(spec.p - 1, W).view(np.int32)).to(dev)
    k = PoseidonKernels.for_params(generate_params(spec, t))
    x = canonical(spec, (t, W, 300), t, dev)
    x[:, :, 0] = pm1
    for conv in (False, True):
        assert torch.equal(k.permute_lm(x, convert_in=conv), k.permute_lm_plain(x, conv)), conv
    a, c = canonical(spec, (t, W, 64), 2 * t, dev), canonical(spec, (t, W, 64), 3 * t, dev)
    a[:, :, 0] = c[:, :, 0] = pm1
    assert torch.equal(sum_products(spec, a, c), sum_products_plain(spec, a, c))


def test_poseidon_client_on_card_matches_oracle(dev):
    spec, height = FIELDS["bls12_381_fr"], 3
    leaf_p, node_p = generate_params(spec, 12), generate_params(spec, 9)
    rng = random.Random(5)
    cols = [[rng.randrange(spec.p) for _ in range(11)] for _ in range(64)]
    raw = b"".join(v.to_bytes(32, "little") for c in cols for v in c)
    want = [v for layer in merkle_tree_ref(leaf_p, node_p, cols, height) for v in layer]
    for stream_leaves in (0, 16):
        _build.reset_launches()
        client = PoseidonClient("bls12_381_fr")
        assert client.ctx.device.type == "cuda"
        client.initialize(PoseidonInitializeParameters(tree_height=height,
                                                       stream_leaves=stream_leaves))
        client.set_data(raw)
        client.start_process()
        client.wait_result()
        got = [int.from_bytes(r.hash, "little") for r in client.result(num_tree_nodes(height))]
        assert got == want
        assert _build.LAUNCHES["poseidon_perm"] > 0 and _build.LAUNCHES["mont_mul"] > 0
    leaves = [rng.randrange(spec.p) for _ in range(8)]
    client = PoseidonClient("bls12_381_fr")
    client.initialize(PoseidonInitializeParameters(tree_height=2, tree_mode=TreeMode.TREE_D))
    client.set_data(b"".join(v.to_bytes(32, "little") for v in leaves))
    client.start_process()
    client.wait_result()
    assert words_to_int(client.root) == poseidon_hash_ref(node_p, leaves)


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr"])
def test_mul_lm_element_rows_match_plain(dev, field):
    """K8's element rows (N = 1, the plan's form) at ragged lengths, two and
    three operands, into a new buffer and in place."""
    spec = FIELDS[field]
    k, W = NTTKernels.for_spec(spec), spec.nwords
    for n in (1, 33, 1000, (1 << 16) + 1):
        x, y, z = (canonical(spec, (n, W), n + i, dev).reshape(n, W, 1) for i in range(3))
        x[0, :, 0] = torch.from_numpy(int_to_words(spec.p - 1, W).view(np.int32)).to(dev)
        for ops in ((y,), (y, z)):
            want = k.mul_lm_plain(x, *ops)
            assert torch.equal(k.mul_lm(x, *ops), want), (n, len(ops))
            buf = x.clone()
            assert k.mul_lm(buf, *ops, out=buf) is buf
            assert torch.equal(buf, want), (n, len(ops), "in place")


def test_ntt_2e16_is_two_k7_and_one_k8(dev):
    """The 2^16 transform (the K8 fallback) launches K7 twice and K8 once,
    with the plan's element-order twiddles and no other device operation
    (no gather, no index, no K1); it equals the plan's plain run."""
    from torch.profiler import ProfilerActivity, profile

    spec = FIELDS["bls12_381_fr"]
    plan = FusedNTT(spec, 16, device=torch.device("cuda", torch.cuda.current_device()))
    rows = plan._twiddle_rows(0, False)
    x = canonical(spec, (plan.n, spec.nwords), 16, dev)
    plan.ntt(x)
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = plan.ntt(x)
        torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    assert (counts["ntt_base"], counts["mul_lm"]) == (2, 1)
    assert sum(counts.values()) == 3
    assert plan._twiddle_rows(0, False) is rows
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0)) > 0}
    assert names and all("ntt_base_kernel" in n or "mul_lm_rows_kernel" in n for n in names), names
    cpu = FusedNTT(spec, 16, device="cpu")
    assert torch.equal(out.cpu(), cpu.ntt(x.cpu()))


def test_pipeline_on_card_matches_its_cpu_run(dev):
    """ProofPipeline at (ntt_logn 12, msm_logn 10) on BLS12-381: three
    batches (one as 16-bit limbs) through run_batches on the card equal the
    same batches through the pipeline on the CPU."""
    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(12)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32))
    resident = points_to_resident(cv, pts).repeat(1, 64).contiguous()
    fr = spec.fr
    batches = [canonical(fr, (1 << 12, fr.nwords), 40 + i, "cpu") for i in range(3)]
    batches[1] = torch.from_numpy(batches[1].numpy().view("<u2").astype(np.int32))
    card = ProofPipeline(cv, 12, 10)
    assert card.ctx.device.type == "cuda"
    got = [r.cpu() for r in card.run_batches([b.to(dev) for b in batches],
                                              resident.to(dev), window_bits=8)]
    want = list(ProofPipeline(cv, 12, 10, device="cpu").run_batches(batches, resident,
                                                                     window_bits=8))
    assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], got[2])


# ------------------------------------------------------- the sharded paths
@pytest.fixture
def one_rank(dev):
    """make_mesh's group of one (NCCL on the card), destroyed afterwards."""
    import torch.distributed as dist

    yield dev
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr"])
def test_batched_ntt_kernels_match_plain_versions(dev, field):
    """K7 and K9 at FusedNTT.ntt_batch's maps (B transforms per launch, the
    batch one more lane field): B = 8 transforms of 2^10 (three levels)
    read at element stride 16 into (n, B) rows, and B = 4 of 2^9 (two
    levels) as (B, n) rows, each level and twiddle against the plain
    version; then the whole batched transform against the CPU plan."""
    from blaze_tpu_torch.ntt.fused import batch_level

    spec = FIELDS[field]
    W = spec.nwords
    card = torch.device("cuda", torch.cuda.current_device())
    for logn, klog, B, src, minor in ((10, 4, 8, (16, 1), True), (9, 5, 4, (1, 512), False)):
        plan = FusedNTT(spec, logn, klog=klog, device=card)
        n = plan.n
        x = canonical(spec, ((n - 1) * src[0] + (B - 1) * src[1] + 1, W), logn, dev)
        buf = canonical(spec, (n * B, W), logn + 1, dev)
        for d, lv0 in enumerate(plan.levels):
            lv = batch_level(lv0, d, logn, B, src, minor)
            pack = plan._packs[(lv.a, False)]
            inp = x if d == 0 else buf
            got = plan.kern.ntt_base(inp, pack, lv.lanes, lv.xmap, out=torch.zeros_like(buf),
                                     omap=lv.omap)
            want = plan.kern.ntt_base_plain(inp, pack, lv.lanes, lv.xmap,
                                            out=torch.zeros_like(buf), omap=lv.omap)
            assert torch.equal(got, want), (logn, d)
            if d + 1 < len(plan.levels):
                t1, t2 = plan._tabs[(d, False)]
                assert torch.equal(plan.kern.twiddle_mul(buf, t1, t2, lv.vshift, lv.fields),
                                   plan.kern.twiddle_mul_plain(buf, t1, t2, lv.vshift,
                                                               lv.fields)), (logn, d)
        cpu = FusedNTT(spec, logn, klog=klog, device="cpu")
        for inverse in (False, True):
            run = "intt_batch" if inverse else "ntt_batch"
            got = getattr(plan, run)(x, B, src[0], src[1], minor)
            assert torch.equal(got.cpu(), getattr(cpu, run)(x.cpu(), B, src[0], src[1], minor))


def test_distributed_msm_on_card_matches_cpu_and_oracle(one_rank):
    """DistributedMSM over NCCL on a mesh of one, bn254, 2^10 distinct
    scalars over 16 tiled subgroup points, window 8: equal to the plain MSM
    on the CPU and to the oracle; K6 once."""
    from blaze_tpu_torch.dist import DistributedMSM, make_mesh
    from blaze_tpu_torch.msm import MSM

    dev = one_rank
    spec = CURVES["bn254"]
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(21)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    n = 1 << 10
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32))
    resident = points_to_resident(cv, pts).repeat(1, n // 16).contiguous()
    scal = torch.from_numpy(scalars_to_limbs(spec, scalars).astype(np.int32)).t().contiguous()
    mesh = make_mesh({"dp": 1})
    _build.reset_launches()
    got = DistributedMSM(cv, mesh)(resident.to(dev), scal.to(dev), window_bits=8)
    assert _build.LAUNCHES["fold_horner"] == 1
    want = MSM(cv)(resident, scal, window_bits=8)
    assert torch.equal(got.cpu(), want)
    X, Y, Z = (words_to_int(v) for v in got.cpu().numpy().view(np.uint32))
    zi = pow(Z, -1, spec.fq.p)
    assert (X * zi % spec.fq.p, Y * zi % spec.fq.p) == class_sum_expected(spec, upoints,
                                                                          scalars)


def test_distributed_ntt_on_card_matches_cpu(one_rank):
    """DistributedNTT over NCCL on a mesh of one, bls12_381_fr at 2^12
    (logn1 6): the k-matrix equals the CPU four-step's, spectral_to_natural
    equals FusedNTT on the card, intt comes back; K7 x2, K9 x1 per ntt."""
    from blaze_tpu_torch.dist import DistributedNTT, make_mesh

    dev = one_rank
    spec = FIELDS["bls12_381_fr"]
    x = canonical(spec, (1 << 12, spec.nwords), 77, dev)
    dntt = DistributedNTT(spec, 12, make_mesh({"sp": 1}), logn1=6)
    _build.reset_launches()
    xk = dntt.ntt(x)
    assert (_build.LAUNCHES["ntt_base"], _build.LAUNCHES["twiddle_mul"]) == (2, 1)
    cpu = FourStepNTT(spec, 12, 6, device="cpu")
    nat = dntt.spectral_to_natural(xk)
    assert torch.equal(nat.cpu(), cpu.ntt(x.cpu()))
    assert torch.equal(nat, FusedNTT(spec, 12, device=x.device).ntt(x))
    k1, k2 = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    assert torch.equal(xk.cpu(), nat.cpu()[torch.from_numpy(k1 + 64 * k2)])
    assert torch.equal(dntt.intt(xk), x)


def test_run_dist_on_card_matches_oracle(one_rank):
    """ProofPipeline(mesh={dp: 1, sp: 1}).run_dist at (2^12, 2^10) on
    BLS12-381: Montgomery e_1 + a e_3, so the scalars are W^i + a W^(3i),
    full width, against the geometric oracle."""
    from blaze_tpu_torch.dist import make_mesh
    from blaze_tpu_torch.pipeline import geometric_msm_oracle

    dev = one_rank
    spec = CURVES["bls12_381"]
    cv, fr = Curve(spec), spec.fr
    oracle = ECOracle(spec)
    rng = random.Random(31)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32))
    resident = points_to_resident(cv, pts).repeat(1, 64).contiguous().to(dev)
    a = rng.randrange(1, fr.p)
    x = torch.zeros((1 << 12, fr.nwords), dtype=torch.int32)
    for row, v in ((1, 1), (3, a)):
        x[row] = torch.from_numpy(int_to_words(v * fr.r % fr.p, fr.nwords).view(np.int32))
    pipe = ProofPipeline(cv, 12, 10, mesh=make_mesh({"dp": 1, "sp": 1}))
    out = pipe.run_dist(x.to(dev), resident, window_bits=8)
    w = fr.root_of_unity(12)
    want = oracle.msm([geometric_msm_oracle(spec, 16, 1 << 10, pow(w, k, fr.p), upoints)
                       for k in (1, 3)], [1, a])
    X, Y, Z = (words_to_int(v) for v in out.cpu().numpy().view(np.uint32))
    zi = pow(Z, -1, spec.fq.p)
    assert (X * zi % spec.fq.p, Y * zi % spec.fq.p) == want
