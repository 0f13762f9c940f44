"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

K1-K6 against their plain PyTorch versions on the same device inputs,
exact, on all three curves (K2-K5 also at ragged lane counts, K6 at
ragged window counts, K2's and K4's gathered forms against their rows
forms), and K7-K10 (with the multi-p REDC twin) on the three
scalar fields (K7 through strided and transposed maps and at the 2^27
plan's levels, K8's element rows at ragged lengths, in place and out of
place), K7-K9 also at W = 12 on bls12_377_fq (a 2^20 transform against
the CPU plan, too), plans past 7 levels against the klog-9 plan, K10
also over the 12-word base fields and at t = 17; the MSM client on the card against the oracle with
distinct scalars; the NTT client on the card against every committed golden
pair, and at 2^16 (the K8 twiddle fallback: K7 twice and K8 once, nothing
else on the card) against a host NTT in Python ints with an inverse
roundtrip; the Poseidon client at height 3, staged, streamed and TREE_D,
against the oracle; the proof pipeline at (2^12, 2^10) against its CPU
run; K7 and K9 at batched maps (FusedNTT.ntt_batch) against their plain
versions, and the sharded paths over NCCL on a mesh of one rank
(DistributedMSM against the plain MSM and the oracle, DistributedNTT
against the CPU four-step and FusedNTT, run_dist against its geometric
oracle); bench_kernel on K1 against cuda_ms and the microbench's spot
check; KF (the Field's elementwise kernel) against its plain version at
both widths and ragged sizes; the MSM chunk as a CUDA graph: the
capture's warm-up and its replays against the eager chunk and the
oracle on the three curves, the launches a replay counts, one graph for
the chunks of one MSM, and a capture that fails raising; a traced
replay split by its stage marks (trace.py), in a fresh process; the
precompute mode on resident operands: the 8x MSM of 2^20 BN254 bases
against the class sums and the plain MSM, and precompute_resident over
2^22 distinct bases against precompute_points; BN254's G2: K2-K6's F_p2
instances (rows and gathered forms) against their plain versions at
ragged lane counts, each counted under its own key, and a 2^20 G2 MSM
through the chunk graph against the plain reference in Python ints.
chip_smoke.py runs the G1 checks at the main path's sizes.
"""
import random
from pathlib import Path

import numpy as np

import pytest
import torch

from blaze_tpu_torch.curves import (
    CURVES,
    G1_CURVES,
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
from blaze_tpu_torch.trace import device_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(G1_CURVES))
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
@pytest.mark.parametrize("name", sorted(G1_CURVES))
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


@pytest.mark.parametrize("name", sorted(G1_CURVES))
def test_scan_gathered_matches_rows_form(dev, name):
    """K2 reading its points through the sort (scan_gathered) equals K2 on
    the rows made from them (scan_mixed of gathered_rows), word for word,
    unsigned and signed: at N = 1000 with R = 32 lanes of C = 32 (24 pads),
    and at N = 4096 with R C = N; the plain version at the small shape.
    Each call launches the gathered form once and the rows form not at
    all."""
    spec = CURVES[name]
    W = spec.fq.nwords
    k = ECKernels.for_curve(spec)
    from blaze_tpu_torch.oracle.gen import rand_words

    for N, R, G in ((1000, 32, 3), (4096, 64, 4)):
        C = -(-N // R)
        pts = rand_words(spec.fq, (2, W, N), N, dev).reshape(2 * W, N)
        g = torch.Generator(device=dev).manual_seed(N)
        key = torch.randint(0, 1 << 9, (G, N), generator=g, dtype=torch.int64, device=dev)
        order = torch.argsort(key, dim=-1, stable=True)
        for sk in (None, key):
            before = dict(_build.LAUNCHES)
            got = k.scan_gathered(pts, order, R, C, sk)
            assert (_build.LAUNCHES["scan_gathered"] - before["scan_gathered"],
                    _build.LAUNCHES["scan_mixed"] - before["scan_mixed"]) == (1, 0)
            want = k.scan_mixed(k.gathered_rows(pts, order, R, C, sk))
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (N, sk is None)
            if N == 1000:
                plain = k.scan_gathered_plain(pts, order, R, C, sk)
                assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("name,G", [("bls12_381", 16), ("bn254", 2)])
def test_reduce_buckets_matches_rows_form(dev, name, G, signed):
    """K4 reading a chunk's bucket sum in place through its bounds
    (reduce_buckets) equals K4 on the rows made from them (reduce_cols of
    bucket_rows) and the plain version, word for word: 16 windows on
    BLS12-381 and 2 on BN254, unsigned (c 8: B 256, 2 pads a window) and
    signed (c 9: B 257, no pad) digits, window 0's lowest buckets empty
    and the last window's bucket 0 in lane 0.  Each call launches the
    gathered form once and the rows form not at all."""
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = CURVES[name]
    W = spec.fq.nwords
    k = ECKernels.for_curve(spec)
    R, C = 64, 48                                    # N = 3072 points a window
    c = 9 if signed else 8
    B = (1 << (c - 1)) + 1 if signed else 1 << c
    emitted = rand_words(spec.fq, (3 * C, W, G * R), G + c, dev).reshape(C, 3 * W, G * R)
    x = rand_words(spec.fq, (3, W, G * R), G + c + 1, dev).reshape(3 * W, G * R)
    g = torch.Generator(device=dev).manual_seed(G + c)
    digits = torch.randint(0, B, (G, R * C), generator=g, dtype=torch.int64, device=dev)
    digits[0] = digits[0].clamp(min=3)
    digits[-1] = digits[-1].clamp(min=1)
    digits[-1, 0] = 0
    hist = torch.zeros((G, B), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, digits, torch.ones_like(digits))
    bounds = torch.cumsum(hist, dim=-1) - 1
    before = dict(_build.LAUNCHES)
    got = k.reduce_buckets(emitted, x, bounds, C, R, B)
    assert (_build.LAUNCHES["reduce_buckets"] - before["reduce_buckets"],
            _build.LAUNCHES["reduce_cols"] - before["reduce_cols"]) == (1, 0)
    assert torch.equal(got, k.reduce_cols(k.bucket_rows(emitted, x, bounds, C, R, B)))
    assert torch.equal(got, k.reduce_buckets_plain(emitted, x, bounds, C, R, B))


@pytest.mark.parametrize("name", sorted(G1_CURVES))
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


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr", "bls12_377_fq"])
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
@pytest.mark.parametrize("name", sorted(G1_CURVES))
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


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr", "bls12_377_fq"])
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
    names = {e.key for e in device_ops(prof)}
    assert names and all("ntt_base_kernel" in n or "mul_lm_rows_kernel" in n for n in names), names
    cpu = FusedNTT(spec, 16, device="cpu")
    assert torch.equal(out.cpu(), cpu.ntt(x.cpu()))


def test_wide_2e20_transform_matches_the_cpu_plan(dev):
    """FusedNTT(bls12_377_fq, 20) on the card (parts 7, 7, 6 of 48-byte
    elements: K7 x3 and K9 x2 at W = 12, no W = 8 launch) equals the same
    plan on the CPU, and its inverse comes back."""
    spec = FIELDS["bls12_377_fq"]
    plan = FusedNTT(spec, 20, device=torch.device("cuda", torch.cuda.current_device()))
    x = canonical(spec, (plan.n, spec.nwords), 20, dev)
    _build.reset_launches()
    out = plan.ntt(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"ntt_base_w12": 3,
                                                              "twiddle_mul_w12": 2}
    assert torch.equal(out.cpu(), FusedNTT(spec, 20, device="cpu").ntt(x.cpu()))
    assert torch.equal(plan.intt(out), x)


@pytest.mark.parametrize("field,logn,klog", [("bls12_377_fr", 22, 3),
                                             ("bls12_377_fq", 15, 2)])
def test_deep_plans_match_the_klog_9_plan(dev, field, logn, klog):
    """Plans past 7 levels at their klog run as 7 levels (fused.plan_parts)
    and equal the klog-9 plan on the card, both ways."""
    spec = FIELDS[field]
    card = torch.device("cuda", torch.cuda.current_device())
    deep, flat = FusedNTT(spec, logn, klog=klog, device=card), FusedNTT(spec, logn, device=card)
    assert len(deep.parts) == 7 and len(flat.parts) < 7
    x = canonical(spec, (deep.n, spec.nwords), logn, dev)
    assert torch.equal(deep.ntt(x), flat.ntt(x))
    assert torch.equal(deep.intt(x), flat.intt(x))


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


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr", "bls12_377_fq"])
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


@pytest.mark.parametrize("field", ["bls12_381_fr", "bls12_377_fq"])
def test_distributed_ntt_on_card_matches_cpu(one_rank, field):
    """DistributedNTT over NCCL on a mesh of one at 2^12 (logn1 6), at W = 8
    and 12: the k-matrix equals the CPU four-step's, spectral_to_natural
    equals FusedNTT on the card, intt comes back; K7 x2, K9 x1 per ntt."""
    from blaze_tpu_torch.dist import DistributedNTT, make_mesh

    dev = one_rank
    spec = FIELDS[field]
    x = canonical(spec, (1 << 12, spec.nwords), 77, dev)
    dntt = DistributedNTT(spec, 12, make_mesh({"sp": 1}), logn1=6)
    _build.reset_launches()
    xk = dntt.ntt(x)
    k = NTTKernels.for_spec(spec)
    assert (_build.LAUNCHES[k.counter("ntt_base")],
            _build.LAUNCHES[k.counter("twiddle_mul")]) == (2, 1)
    assert sum(_build.LAUNCHES.values()) == 3
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


def test_bench_kernel_times_k1_as_cuda_ms_does(dev):
    """bench_kernel on K1 (2^19 BLS12-381 base-field products) against
    cuda_ms on the same launches: the same CUDA-event timing behind a spin,
    so the best of its groups is within 25% of cuda_ms's mean."""
    from blaze_tpu_torch.bench.profile import bench_kernel, cuda_ms, kernel_work
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = FIELDS["bls12_381_fq"]
    a = rand_words(spec, (1 << 19, 12), 1, dev)
    b = rand_words(spec, (1 << 19, 12), 2, dev)
    stats = bench_kernel(lambda x, y: mont_mul(spec, x, y), (a, b), name="K1", reps=50,
                         work=kernel_work("mont_mul", {"M": 1 << 19}, 12))
    ms = cuda_ms(lambda: mont_mul(spec, a, b), 50)
    assert stats.best_s <= stats.median_s
    assert abs(stats.best_s * 1e3 - ms) < 0.25 * ms
    assert stats.bound_by == "bytes" and 0 < stats.bound_fraction < 1


def test_microbench_on_card_spot_checks_k1_and_k8(dev):
    from blaze_tpu_torch.bench import microbench

    recs = microbench.run("bls12_381_fr", 16, "cuda", reps=20)
    assert [r["kernel"] for r in recs] == ["mont_mul", "mul_lm"]
    assert all(r["spot_check"] and r["ms"] > 0 for r in recs)


def any_words(spec, shape, seed, dev):
    """int32 words of any value (KF equals its plain version on any input)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, size=(*shape, spec.nwords), dtype=np.int32)).to(dev)


@pytest.mark.parametrize("n", [1, 33, 1000])
@pytest.mark.parametrize("field", ["bn254_fq", "bls12_381_fr", "bls12_381_fq", "bls12_377_fq"])
def test_field_ew_matches_plain(dev, field, n):
    """KF against its plain version, exact, at both widths and ragged sizes:
    every op on canonical values and on any words, canon with and without
    a carry word, and operands that broadcast."""
    from blaze_tpu_torch.fields.elementwise import OPS, field_ew, field_ew_plain

    spec = FIELDS[field]
    W = spec.nwords
    canon_a, canon_b = (canonical(spec, (n, W), n + i, dev) for i in range(2))
    raw_a, raw_b = (any_words(spec, (n,), 2 * n + i, dev) for i in range(2))
    top = torch.randint(0, 2, (n,), generator=torch.Generator().manual_seed(n)).to(dev)
    before = _build.LAUNCHES["field_ew"]
    for a, b in ((canon_a, canon_b), (raw_a, raw_b)):
        for op in OPS:
            y = None if op == "canon" else b
            assert torch.equal(field_ew(spec, op, a, y), field_ew_plain(spec, op, a, y)), op
        assert torch.equal(field_ew(spec, "canon", a, top), field_ew_plain(spec, "canon", a, top))
    a3, b3 = canon_a[:, None], canon_b[: min(n, 3)][None]
    for op in ("add", "sub"):
        assert torch.equal(field_ew(spec, op, a3, b3), field_ew_plain(spec, op, a3, b3)), op
    assert _build.LAUNCHES["field_ew"] - before == 2 * (len(OPS) + 1) + 2


def msm_case(spec, n: int, seed: int, dev):
    """(resident points, resident scalars, 16 subgroup points, scalars) of n
    distinct full-width scalars over 16 subgroup points tiled, on `dev`."""
    cv = Curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(seed)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    resident = points_to_resident(cv, pts).repeat(1, n // 16).contiguous()
    scal = torch.from_numpy(scalars_to_limbs(spec, scalars).astype(np.int32)).t().contiguous()
    return resident, scal.to(dev), upoints, scalars


def affine_ints(spec, out):
    X, Y, Z = (words_to_int(v) for v in out.cpu().numpy().view(np.uint32))
    zi = pow(Z, -1, spec.fq.p)
    return (X * zi % spec.fq.p, Y * zi % spec.fq.p)


@pytest.mark.parametrize("name", sorted(G1_CURVES))
def test_replayed_chunk_matches_eager_and_oracle(dev, name):
    """A chunk shape's first chunk (the capture's eager warm-up) and its
    replays equal `_fused_chunk` run eagerly word for word, and a second
    input of the same shape replays the same graph into an MSM equal to
    the oracle.  A replay adds the launches its capture recorded: one K2
    (its gathered form; the rows form none), no K1, one K4 in its gathered
    form and its later rounds, the K3 rounds and group ops, the KF ops."""
    from blaze_tpu_torch.msm import MSM

    spec = CURVES[name]
    cv = Curve(spec)
    msm = MSM(cv)
    n, c = 1 << 12, 8
    res, scal, _, _ = msm_case(spec, n, 31, dev)
    eager = msm._fused_chunk(res, scal, c)
    first = msm.msm_partial(res, scal, c)
    assert len(msm._graphs) == 1 and msm.graph_pool_bytes > 0
    (graph,) = msm._graphs.values()
    _build.reset_launches()
    replayed = msm.msm_partial(res, scal, c)
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert torch.equal(first, eager) and torch.equal(replayed, eager)
    assert counts == graph.launches
    R = 1 << 6                                          # sqrt(2^12) lanes per window
    assert counts["scan_gathered"] == 1 and "scan_mixed" not in counts
    assert counts["dbl_n"] == 1 and "mont_mul" not in counts
    # the bucket sum: K4's gathered first pass (M 510 points a window on 32
    # lanes), then three rows-form rounds down to one lane a window
    assert counts["reduce_buckets"] == 1 and counts["reduce_cols"] == 3
    assert counts["ec_add"] == R.bit_length() - 1 + 3 and counts["field_ew"] >= 5
    res2, scal2, upoints, scalars = msm_case(spec, n, 32, dev)
    out = msm(res2, scal2, window_bits=c)
    assert len(msm._graphs) == 1
    assert affine_ints(spec, out) == class_sum_expected(spec, upoints, scalars)


def test_chunks_of_one_msm_replay_one_graph(dev):
    """An MSM of four chunks (chunk_log2 10): one capture, its result the
    same point as the one-chunk MSM's (the projective words differ with
    the order of the adds) and the oracle's; K2 once per chunk, K6 once."""
    from blaze_tpu_torch.msm import MSM, MSMConfig

    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    res, scal, upoints, scalars = msm_case(spec, 1 << 12, 33, dev)
    chunked = MSM(cv, MSMConfig(chunk_log2=10))
    _build.reset_launches()
    out = chunked(res, scal, window_bits=8)
    assert _build.LAUNCHES["scan_gathered"] == 4 and _build.LAUNCHES["fold_horner"] == 1
    assert len(chunked._graphs) == 1
    want = class_sum_expected(spec, upoints, scalars)
    assert affine_ints(spec, out) == affine_ints(spec, MSM(cv)(res, scal, window_bits=8)) == want


def test_failed_capture_raises(dev, monkeypatch):
    """A chunk that syncs with the host cannot be captured: the call
    raises, and no graph is kept."""
    from blaze_tpu_torch.msm import MSM

    spec = CURVES["bn254"]
    msm = MSM(Curve(spec))
    res, scal, _, _ = msm_case(spec, 1 << 10, 34, dev)
    chunk = msm._fused_chunk

    def syncing(*args):
        out = chunk(*args)
        out.sum().item()                  # a host sync: not allowed in a capture
        return out

    monkeypatch.setattr(msm, "_fused_chunk", syncing)
    with pytest.raises(RuntimeError):
        msm.msm_partial(res, scal, 8)
    assert not msm._graphs
    torch.cuda.synchronize()


def test_resident_precomputed_msm_2e20_bn254_matches_class_sums(dev):
    """blaze's 8x mode on resident operands at 2^20 BN254 bases: 16
    oracle points expanded on the card (precompute_resident), tiled
    multiple-major to 2^23 columns, and 2^20 distinct full-width scalars
    left unsliced.  The result equals the class sums and the plain MSM of
    the same scalars; two chunks per multiple (chunk_log2 16: the plan's
    2^19 points at two windows), K2 once per chunk, K6 once."""
    from blaze_tpu_torch.msm import MSM, MSMConfig, precompute_resident

    spec = CURVES["bn254"]
    cv = Curve(spec)
    n, k, W = 1 << 20, 8, cv.nwords
    res, _, upoints, _ = msm_case(spec, 16, 35, dev)
    mult = precompute_resident(cv, res, k)
    bases = mult.reshape(2 * W, k, 1, 16).expand(2 * W, k, n // 16, 16).reshape(2 * W, k * n)
    g = torch.Generator(device=dev).manual_seed(35)
    low = torch.randint(0, 1 << 16, (15, n), dtype=torch.int32, device=dev, generator=g)
    top = torch.randint(0, spec.fr.p >> 240, (1, n), dtype=torch.int32, device=dev, generator=g)
    scalars = torch.cat([low, top])
    msm = MSM(cv, MSMConfig(chunk_log2=16))
    _build.reset_launches()
    out = msm.msm_precomputed(bases, scalars, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fold_horner"] == 1 and _build.LAUNCHES["scan_gathered"] == 2 * k
    assert len(msm._graphs) == 1 and msm.chunk_plans == {(2, 1 << 19, 2048): 2 * k}
    want = class_sum_expected(spec, upoints, scalars.t().cpu().numpy().astype(np.uint32))
    plain = MSM(cv)(res.repeat(1, n // 16), scalars)
    assert affine_ints(spec, out) == affine_ints(spec, plain) == want


def test_widened_two_window_plan_matches_cpu_and_oracle(dev):
    """A precomputed MSM at two windows a chunk (BN254, 16 multiples of
    16-bit slices, c = 8: the 8x mode's G at buckets the CPU sums in
    seconds) with chunk_log2 7: the plan widens a chunk 8x to 2^10 points
    on 128 lanes a window, and 2^11 bases make two chunks in each
    multiple.  The card's MSM (one graph, replayed) equals the CPU's eager
    MSM word for word and the class sums."""
    from blaze_tpu_torch.msm import MSM, MSMConfig, precompute_resident

    spec = CURVES["bn254"]
    cv = Curve(spec)
    n, k, W = 1 << 11, 16, cv.nwords
    res, _, upoints, _ = msm_case(spec, 16, 37, dev)
    mult = precompute_resident(cv, res, k)
    bases = mult.reshape(2 * W, k, 1, 16).expand(2 * W, k, n // 16, 16).reshape(2 * W, k * n)
    g = torch.Generator(device=dev).manual_seed(37)
    low = torch.randint(0, 1 << 16, (15, n), dtype=torch.int32, device=dev, generator=g)
    top = torch.randint(0, spec.fr.p >> 240, (1, n), dtype=torch.int32, device=dev, generator=g)
    scalars = torch.cat([low, top])
    msm = MSM(cv, MSMConfig(chunk_log2=7))
    _build.reset_launches()
    out = msm.msm_precomputed(bases, scalars, k, window_bits=8)
    torch.cuda.synchronize()
    assert msm.chunk_plans == {(2, 1 << 10, 128): 2 * k} and len(msm._graphs) == 1
    assert _build.LAUNCHES["scan_gathered"] == 2 * k and _build.LAUNCHES["fold_horner"] == 1
    eager = MSM(cv, MSMConfig(chunk_log2=7)).msm_precomputed(bases.cpu(), scalars.cpu(), k,
                                                              window_bits=8)
    assert torch.equal(out.cpu(), eager)
    want = class_sum_expected(spec, upoints, scalars.t().cpu().numpy().astype(np.uint32))
    assert affine_ints(spec, out) == want


def test_precompute_resident_2e22_distinct_bases_matches_the_plain_expansion(dev):
    """precompute_resident over 2^22 distinct BN254 bases, 2^20 a block,
    equals precompute_points (the Field's doublings, multiple by
    multiple) followed by points_to_resident word for word."""
    from blaze_tpu_torch.msm import points_to_resident, precompute_points, precompute_resident
    from blaze_tpu_torch.msm.residency import points_from_resident
    from blaze_tpu_torch.oracle.gen import distinct_resident_points

    spec = CURVES["bn254"]
    cv = Curve(spec)
    res = distinct_resident_points(spec, 1 << 22, 36, dev)
    got = precompute_resident(cv, res, 8, block=1 << 20)
    want = points_to_resident(cv, precompute_points(cv, points_from_resident(cv, res), 8),
                              mont=True)
    assert got.shape == (2 * cv.nwords, 8 << 22) and torch.equal(got, want)


def _stage_trace(path: str) -> None:
    """The traced MSM of test_stage_marks_split_a_traced_chunk_replay, in a
    process of its own (torch.profiler loses the card's events in a process
    older than ~40 s): writes to `path` the mark launches counted, the
    launches traced, each stage's device us (its mark's operations up to
    the next mark) and mark-to-mark us in the trace, and MSM.stage_ms()'s
    change over the call."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile

    from blaze_tpu_torch.msm import MSM
    from blaze_tpu_torch.trace import traced_launches

    spec = CURVES["bls12_381"]
    msm = MSM(Curve(spec))
    res, scal, _, _ = msm_case(spec, 1 << 19, 35, torch.device("cuda"))
    msm(res, scal)                                          # the capture
    torch.cuda.synchronize()
    before, counts = msm.stage_ms(), dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        msm(res, scal)
        torch.cuda.synchronize()
    after = msm.stage_ms()
    trace = Path(path).with_suffix(".trace.json")
    prof.export_chrome_trace(str(trace))
    device = sorted((e["ts"], e["dur"], e["name"]) for e in json.loads(
        trace.read_text())["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, spans, stage, opened = {}, {}, "none", 0.0
    for ts, dur, name in device:
        m = re.search(r"\bmark_(\w+?)_kernel\b", name)
        if m:
            spans[stage] = spans.get(stage, 0.0) + ts - opened
            stage, opened = m[1], ts
        busy[stage] = busy.get(stage, 0.0) + dur
    Path(path).write_text(json.dumps({
        "launched": {k: v - counts[k] for k, v in _build.LAUNCHES.items() if v != counts[k]},
        "traced": traced_launches((n, 1) for _, _, n in device),
        "busy_us": busy, "mark_to_mark_us": spans,
        "clock_ms": {k: after[k] - before[k] for k in after}}))


def test_stage_marks_split_a_traced_chunk_replay(dev, tmp_path):
    """One traced 2^19 MSM (BLS12-381, c 16: one chunk, its graph replayed),
    in a fresh process: every mark is in the device trace; the five
    stages' device ms (each mark's operations up to the next mark) sum to
    the call's device ms within 2%; and MSM.stage_ms() gives each stage's
    mark-to-mark time in the trace within 2%."""
    import json
    import subprocess
    import sys

    from blaze_tpu_torch.trace import MSM_STAGES, check_trace

    path = tmp_path / "split.json"
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).parent)!r}); "
            f"import test_torch_cuda as t; t._stage_trace({str(path)!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(path.read_text())
    launched = r["launched"]
    assert {k: v for k, v in launched.items() if k.startswith("mark_")} == {
        "mark_msm_stream": 2, "mark_msm_sort": 1, "mark_msm_layout": 1, "mark_msm_scan": 1,
        "mark_msm_bucket": 1, "mark_msm_done": 1}
    check_trace(r["traced"], launched, "chunk replay")
    busy = r["busy_us"]
    assert sum(busy.get(s, 0.0) for s in MSM_STAGES) == pytest.approx(
        sum(busy.values()), rel=0.02)
    clock = r["clock_ms"]
    assert clock["calls"] == 1
    for s in MSM_STAGES:
        assert clock[s.removeprefix("msm_")] == pytest.approx(
            r["mark_to_mark_us"][s] / 1e3, rel=0.02, abs=0.005), s


# ------------------------------------------------ the probes of experiments/
PROBE_FIELDS = ("bls12_381_fr", "bls12_381_fq")      # W = 8 and 12


@pytest.mark.parametrize("field", PROBE_FIELDS)
def test_probe_chain_matches_plain(dev, field):
    """csrc/probe_chain.cu: every body (E2-E5's) at S = 1 and the stream
    bodies at S = 4, chained 3 steps on ragged lane counts, exact."""
    from blaze_tpu_torch.experiments.chain import (BODIES, STREAM_BODIES, probe_chain,
                                                   probe_chain_plain)
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = FIELDS[field]
    W = spec.nwords
    for n in (1, 33, 1000):
        b = rand_words(spec, (n, W), n, dev)
        for S in (1, 4):
            x = rand_words(spec, (S * n, W), n + S, dev)
            for body in BODIES if S == 1 else STREAM_BODIES:
                before = _build.LAUNCHES["probe_chain"]
                got = probe_chain(spec, body, x, b, 3, S)
                assert _build.LAUNCHES["probe_chain"] == before + 1
                assert torch.equal(got, probe_chain_plain(spec, body, x, b, 3, S)), (body, n, S)


def test_probe_mixed_matches_plain(dev):
    """E5's mixed-add body on the team of six (probe_chain.cu), twice per
    lane, at ragged lane counts, exact."""
    from blaze_tpu_torch.experiments.chain import probe_mixed, probe_mixed_plain
    from blaze_tpu_torch.oracle.gen import rand_words

    curve = CURVES["bls12_381"]
    spec = curve.fq
    W = spec.nwords
    for B in (1, 33, 1000):
        p = rand_words(spec, (3, W, B), B, dev).reshape(3 * W, B)
        q = rand_words(spec, (2, W, B), B + 1, dev).reshape(2 * W, B)
        assert torch.equal(probe_mixed(curve, p, q, 2), probe_mixed_plain(curve, p, q, 2))


@pytest.mark.parametrize("field", PROBE_FIELDS)
def test_mont_tc_matches_plain(dev, field):
    """csrc/mont_tc.cu (E1 and E2's mm_i8 / qmm_i8): each mode chained 3
    steps at ragged lane counts (a warp's 32 elements cut short), exact;
    one product equal to K1's."""
    from blaze_tpu_torch.experiments.chain import TC_MODES, mont_tc, mont_tc_plain
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = FIELDS[field]
    W = spec.nwords
    for n in (1, 33, 1000):
        a, b = rand_words(spec, (n, W), n, dev), rand_words(spec, (n, W), n + 1, dev)
        for mode in TC_MODES:
            bb = b if mode == "mont" else None
            assert torch.equal(mont_tc(spec, mode, a, bb, 3), mont_tc_plain(spec, mode, a, bb, 3))
        assert torch.equal(mont_tc(spec, "mont", a, b), mont_mul(spec, a, b))


@pytest.mark.parametrize("field", PROBE_FIELDS)
def test_product_forms_equal_k0_on_the_card(dev, field):
    """Every form of the product among the probe bodies (K0's mont, the lo /
    hi form mont_hi and the others) equals K0's product and K1 word for
    word, on random operands and operands near p, chained 1 and 3 steps."""
    from blaze_tpu_torch.experiments.chain import PRODUCT_BODIES, probe_chain
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = FIELDS[field]
    W = spec.nwords
    n = 1000
    x = rand_words(spec, (n, W), 5, dev)
    b = rand_words(spec, (n, W), 6, dev)
    near = torch.as_tensor(np.stack([int_to_words(spec.p - 1 - k, W) for k in range(8)])
                           .view(np.int32), device=dev)
    x[:8], b[:8], b[8:16] = near, near, near
    assert torch.equal(probe_chain(spec, "mont", x, b, 1), mont_mul(spec, x, b))
    for M in (1, 3):
        want = probe_chain(spec, "mont", x, b, M)
        for body in PRODUCT_BODIES:
            assert torch.equal(probe_chain(spec, body, x, b, M), want), (body, M)


# ------------------------------------------------------------ BN254's G2
def g2_rows(cv, B: int, C: int, seed: int, dev):
    """(C, 2W, B) Montgomery affine rows of 16 G2 points k P2 (the plain
    reference's), W = 16, and a (C, 1, B) 0/1 sign row."""
    from zkbench.reference import bn254_g2

    pts = bn254_g2.subgroup_points(16, seed)
    aff = cv.fq.from_int([c for pt in pts for c in pt], device=dev).reshape(16, 2, -1)
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, 16, size=C * B)).to(dev)
    rows = aff[idx].reshape(C, B, -1).permute(0, 2, 1).contiguous()
    sgn = torch.randint(0, 2, (C, 1, B), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    return rows, torch.cat([rows, sgn], dim=1).contiguous()


def launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("B", [1, 33, 256])
def test_g2_kernels_match_plain_versions(dev, B):
    """K2 (rows; unsigned and signed, C = 1 and 4), K3 (p = q and
    identities among its operands), K4 (rows, identities among them), K5 and
    K6 (Wn 1, 6, 16 and 40, past 48 KB of shared memory) on F_p2
    coordinates against their plain versions, word for word, at ragged lane
    counts; each launch counted under its `_fp2` key and none under G1's;
    the one-thread F_p2 product chain too."""
    spec = CURVES["bn254_g2"]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    rows, rows_s = g2_rows(cv, B, 4, B + 3, dev)
    for r in (rows, rows_s):
        for C in (1, 4):
            x = r[:C].contiguous()
            before = dict(_build.LAUNCHES)
            got = k.scan_mixed(x)
            assert launched(before) == {"scan_g2_mixed": 1}
            want = k.scan_mixed_plain(x)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (C, r.shape)
    em = got[0]
    ident = cv.identity(device=dev).reshape(-1, 1)
    p, q = em[1].clone(), em[3].clone()
    p[:, ::3] = ident
    q[:, 1::3] = p[:, 1::3]
    before = dict(_build.LAUNCHES)
    assert torch.equal(k.add(p, q), k.add_plain(p, q))
    rc = em.clone()
    rc[1, :, ::3] = ident
    assert torch.equal(k.reduce_cols(rc), k.reduce_cols_plain(rc))
    assert torch.equal(k.dbl_n(p, 5), k.dbl_n_plain(p, 5))
    assert launched(before) == {"ec_g2_add": 1, "reduce_g2_cols": 1, "dbl_g2_n": 1}
    if B == 256:
        lazy = torch.cat([em[c] for c in range(4)], dim=1)           # (48, 1024)
        lazy[:, 5::7] = ident
        for Wn, c in ((1, 13), (6, 5), (16, 16), (40, 2)):
            ws = lazy[:, 100:100 + Wn].contiguous()
            assert torch.equal(k.fold_horner(ws, c), k.fold_horner_plain(ws, c)), (Wn, c)
        x, y = em[0, :, 0].contiguous()[:16], em[1, :, 1].contiguous()[16:32]
        assert torch.equal(k.product_chain(x, y, 7).cpu(),
                           k.product_chain_plain(x.cpu(), y.cpu(), 7))


def test_g2_gathered_forms_match_rows_forms(dev):
    """K2 through the sort (scan_gathered) and K4 through the bounds
    (reduce_buckets) on F_p2 against their rows forms and plain versions,
    word for word, unsigned and signed; counted under scan_g2_gathered and
    reduce_g2_buckets."""
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = CURVES["bn254_g2"]
    k = ECKernels.for_curve(spec)
    N, R, G = 1000, 32, 3
    C = -(-N // R)
    pts = rand_words(spec.fq, (4, 8, N), 5, dev).reshape(32, N)
    g = torch.Generator(device=dev).manual_seed(N)
    key = torch.randint(0, 1 << 9, (G, N), generator=g, dtype=torch.int64, device=dev)
    order = torch.argsort(key, dim=-1, stable=True)
    for sk in (None, key):
        before = dict(_build.LAUNCHES)
        got = k.scan_gathered(pts, order, R, C, sk)
        assert launched(before) == {"scan_g2_gathered": 1}
        want = k.scan_mixed(k.gathered_rows(pts, order, R, C, sk))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), sk is None
        plain = k.scan_gathered_plain(pts, order, R, C, sk)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    G, R, C = 2, 16, 24
    for c in (6, 7):
        B = 1 << c if c == 6 else (1 << (c - 1)) + 1
        emitted = rand_words(spec.fq, (6 * C, 8, G * R), c, dev).reshape(C, 48, G * R)
        x = rand_words(spec.fq, (6, 8, G * R), c + 1, dev).reshape(48, G * R)
        g = torch.Generator(device=dev).manual_seed(c)
        digits = torch.randint(0, B, (G, R * C), generator=g, dtype=torch.int64, device=dev)
        digits[0] = digits[0].clamp(min=3)
        hist = torch.zeros((G, B), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, digits, torch.ones_like(digits))
        bounds = torch.cumsum(hist, dim=-1) - 1
        before = dict(_build.LAUNCHES)
        got = k.reduce_buckets(emitted, x, bounds, C, R, B)
        assert launched(before) == {"reduce_g2_buckets": 1}
        assert torch.equal(got, k.reduce_cols(k.bucket_rows(emitted, x, bounds, C, R, B)))
        assert torch.equal(got, k.reduce_buckets_plain(emitted, x, bounds, C, R, B))


def test_g2_msm_2e20_matches_reference(dev):
    """A 2^20-point G2 MSM (16 bases k P2 tiled, full-width scalars made on
    the card) through MSM.__call__ on resident bases: two chunks, each a
    replay of the chunk's CUDA graph, equal in affine form to the plain
    reference's MSM of the class sums, each of the six F_p words of the
    result canonical and Z nonzero; the chunks launch the F_p2 kernels
    alone."""
    from blaze_tpu_torch.msm import MSM
    from zkbench.reference import bn254_g2

    spec = CURVES["bn254_g2"]
    cv = Curve(spec)
    n, U = 1 << 20, 16
    pts = bn254_g2.subgroup_points(U, 41)
    aff = cv.fq.from_int([c for pt in pts for c in pt], mont=False, device=dev)
    resident = points_to_resident(cv, aff.reshape(U, 2, -1)).repeat(1, n // U).contiguous()
    g = torch.Generator(device=dev).manual_seed(43)
    low = torch.randint(0, 1 << 16, (15, n), generator=g, dtype=torch.int32, device=dev)
    top = torch.randint(0, spec.fr.p >> 240, (1, n), generator=g, dtype=torch.int32,
                        device=dev)
    scal = torch.cat([low, top]).contiguous()
    msm = MSM(cv)
    msm(resident, scal)                                   # the capture
    before = dict(_build.LAUNCHES)
    out = msm(resident, scal)
    counts = launched(before)
    assert counts["scan_g2_gathered"] == 2 and counts["fold_g2_horner"] == 1
    assert not {"scan_gathered", "reduce_buckets", "ec_add", "fold_horner"} & set(counts)
    cols = scal.reshape(16, n // U, U).to(torch.int64).sum(dim=1).cpu()
    sums = [sum(int(v) << (16 * l) for l, v in enumerate(cols[:, u].tolist())) % spec.fr.p
            for u in range(U)]
    words = out.reshape(3, 2, 8).cpu().numpy().view(np.uint32)
    X, Y, Z = (tuple(words_to_int(c) for c in coord) for coord in words)
    assert max(*X, *Y, *Z) < spec.fq.p and Z != (0, 0)
    zi = bn254_g2.inv(Z)
    assert (bn254_g2.mul(X, zi), bn254_g2.mul(Y, zi)) == bn254_g2.tiled_msm(pts, sums)
