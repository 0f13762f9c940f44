"""The port's NTT over the 12-word field bls12_377_fq (48-byte elements, the
scalar field of BW6-761, 2-adicity 46) against the JAX package, on the CPU
(the plain versions of K7-K9).

Same inputs, made with seeded numpy, go through blaze_tpu's Pallas NTT
kernels in interpret mode at L = 24 limbs, its FusedNTT (interpret mode),
NTTPlan and NTTClient, and through the port's plain K7-K9 at W = 12, its
FusedNTT, NTTPlan, FourStepNTT, DistributedNTT (gloo groups of 1, 2 and 4
ranks) and NTTClient(device="cpu").  Every comparison is of integers and
exact.  Element widths other than the kernels' builds (8 and 12 words)
are refused.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS
from blaze_tpu.ntt import FusedNTT as RefFusedNTT, NTTKernels as RefNTTKernels, NTTPlan as RefNTTPlan
from blaze_tpu.runtime import NTTClient as RefNTTClient, NTTInit as RefNTTInit, NTTInput as RefNTTInput
from blaze_tpu_torch.fields import FIELDS, FieldSpec, int_to_words
from blaze_tpu_torch.ntt import FourStepNTT, FusedNTT, NTTKernels, NTTPlan, make_ntt
from blaze_tpu_torch.ntt import tables_from_reference
from blaze_tpu_torch.ntt.fused import plan_levels
from blaze_tpu_torch.ntt.kernels import TileMap
from blaze_tpu_torch.runtime import NTTClient, NTTInit, NTTInput
from torch_dist_worker import CASES, join_ranks, start_ranks

torch.set_num_threads(1)

FIELD = "bls12_377_fq"
SPEC = FIELDS[FIELD]
W = SPEC.nwords


def rand_words(shape, seed: int) -> np.ndarray:
    """(*shape, W) uint32 words of random values below 2^(bits-1) < p."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(*shape, W), dtype=np.uint32)
    w[..., -1] &= (1 << (SPEC.bits - 1 - 32 * (W - 1))) - 1
    return w


def as_t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.uint32).view(np.int32))


def limbs(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> (..., 2W) 16-bit limbs as uint32."""
    return np.ascontiguousarray(w, dtype=np.uint32).view("<u2").astype(np.uint32)


def lm(w: np.ndarray):
    """(R, N, W) words -> the port's (R, W, N) tensor and the JAX package's
    (R, L, N) limbs."""
    return as_t(w.transpose(0, 2, 1).copy()), jnp.asarray(np.moveaxis(limbs(w), -1, 1))


def ref_words(a) -> torch.Tensor:
    """The JAX package's (R, L, N) limbs -> (R, W, N) int32 words."""
    pm = np.moveaxis(np.asarray(a).astype("<u2"), 1, -1).copy().view("<u4")
    return as_t(np.moveaxis(pm, -1, 1).copy())


def words_of(limb_arr) -> np.ndarray:
    """(..., L) 16-bit limbs (any integer array) -> (..., W) uint32 words."""
    return np.ascontiguousarray(np.asarray(limb_arr).astype("<u2")).view("<u4")


@pytest.fixture(scope="module")
def ref_kern():
    return RefNTTKernels.for_spec(REF_FIELDS[FIELD], interpret=True)


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("layout", ["rows", "level1_of_334"])
def test_ntt_base_plain_matches_pallas_kernel(ref_kern, layout):
    """K7 at W = 12: natural-order input read through the layout's map
    against the JAX kernel fed the same lanes' bit-reversed rows at L = 24
    ((K, B) rows out of place; level 1 of a 2^10 plan, in place)."""
    K, B = 8, 128
    lv = None if layout == "rows" else plan_levels([3, 3, 4])[1]
    xmap = TileMap.rows(B) if lv is None else lv.xmap
    omap = xmap if lv is None else lv.omap
    x = rand_words((K * B,), 1)
    pack = rand_words((K,), 2)
    pack[[0, 1, 3]] = int_to_words(SPEC.r % SPEC.p, W)          # W^0 = 1 at m - 1
    rows = xmap.offsets(K, B, "cpu").numpy()
    _, xref = lm(x[rows[[0, 4, 2, 6, 1, 5, 3, 7]]])
    packref = jnp.asarray(np.broadcast_to(limbs(pack)[:, :, None],
                                          (K, 2 * W, 128)).astype(np.uint16))
    want = ref_kern.ntt_base(xref, packref)
    k = NTTKernels.for_spec(SPEC)
    xt = as_t(x)
    in_place = lv is not None
    got = k.ntt_base(xt, as_t(pack), B, xmap, out=xt if in_place else None, omap=omap)
    assert (got is xt) == in_place
    assert torch.equal(got[omap.offsets(K, B, "cpu")].transpose(1, 2), ref_words(want))


@pytest.mark.parametrize("operands", [2, 3])
def test_mul_lm_plain_matches_pallas_kernel(ref_kern, operands):
    """K8 at W = 12, on (M, W, N) batches and on the plan's element rows."""
    ops = [lm(rand_words((2, 128), 10 + i)) for i in range(operands)]
    want = ref_words(ref_kern.mul_lm(*[r for _, r in ops]))
    k = NTTKernels.for_spec(SPEC)
    assert torch.equal(k.mul_lm(*[t for t, _ in ops]), want)
    rows = [t.transpose(1, 2).reshape(-1, W, 1).contiguous() for t, _ in ops]
    assert torch.equal(k.mul_lm(*rows), want.transpose(1, 2).reshape(-1, W, 1))


@pytest.mark.parametrize("A,J,S,B", [(4, 4, 8, 1), (4, 2, 4, 8)])
def test_twiddle_mul_plain_matches_pallas_kernel(ref_kern, A, J, S, B):
    """K9 at W = 12, both branches of the JAX kernel (B = 1 and B > 1), on
    element rows v * lanes + j * B + b from (A, J, W) and (A, S, W) tables."""
    lanes = J * S * B
    yw = rand_words((A, lanes), 20)
    t1w, t2w = rand_words((A, J), 21), rand_words((A, S), 22)
    want = ref_kern.twiddle_mul(lm(yw)[1], lm(t1w)[1], lm(t2w)[1], B)
    want = ref_words(want).transpose(1, 2).reshape(A * lanes, W)
    k = NTTKernels.for_spec(SPEC)
    fields = ((B.bit_length() - 1, (J * S).bit_length() - 1, 0),)
    y = as_t(yw.reshape(A * lanes, W))
    assert torch.equal(k.twiddle_mul(y, as_t(t1w), as_t(t2w), lanes.bit_length() - 1, fields),
                       want)


@pytest.mark.parametrize("p", [(1 << 61) - 1, (1 << 127) - 1])
def test_other_widths_are_refused(p):
    """2 and 4 words: neither the kernels nor a plan take them."""
    spec = FieldSpec(f"m{p.bit_length()}", p)
    with pytest.raises(ValueError, match="words"):
        NTTKernels(spec)
    with pytest.raises(ValueError, match="words"):
        make_ntt(spec, 1, device="cpu")


# ------------------------------------------------------------------ plans
def test_fused_and_tables_match_reference_fused():
    """FusedNTT(6, klog 3): its packs and split tables equal blaze_tpu's
    FusedNTT's through tables_from_reference, and forward and inverse
    equal blaze_tpu's FusedNTT in interpret mode (the K8 fallback at this
    size in both) and its NTTPlan."""
    logn, klog = 6, 3
    ref = RefFusedNTT(REF_FIELDS[FIELD], logn, klog=klog, interpret=True)
    plan = FusedNTT(SPEC, logn, klog=klog, device="cpu")
    assert plan.parts == ref.parts == [3, 3]
    packs, tabs = tables_from_reference(
        {k: np.asarray(v) for k, v in ref._packs.items()},
        {k: tuple(np.asarray(t) for t in v) for k, v in ref._tabs.items()})
    assert sorted(packs) == sorted(plan._packs) and sorted(tabs) == sorted(plan._tabs)
    assert all(torch.equal(plan._packs[k], v) for k, v in packs.items())
    assert all(v[0].shape[-1] == W and torch.equal(plan._tabs[k][0], v[0])
               and torch.equal(plan._tabs[k][1], v[1]) for k, v in tabs.items())
    x = rand_words((1 << logn,), 30)
    xt, xl = as_t(x), jnp.asarray(limbs(x))
    portable = RefNTTPlan(REF_FIELDS[FIELD], logn)
    for got, fused, plain in ((plan.ntt(xt), ref.ntt, portable.ntt),
                              (plan.intt(xt), ref.intt, portable.intt)):
        want = np.asarray(plain(xl), np.uint32)
        assert np.array_equal(limbs(got.numpy().view(np.uint32)), want)
        assert np.array_equal(np.asarray(fused(xl), np.uint32), want)


@pytest.fixture(scope="module")
def ref_ntt():
    """(x, forward, inverse) of blaze_tpu's NTTPlan over three vectors of
    2^logn elements, as (3, n, W) words, once per logn."""
    cache = {}

    def get(logn):
        if logn not in cache:
            x = rand_words((3, 1 << logn), 40 + logn)
            ref = RefNTTPlan(REF_FIELDS[FIELD], logn)
            xl = jnp.asarray(limbs(x))
            cache[logn] = x, words_of(ref.ntt(xl)), words_of(ref.intt(xl))
        return cache[logn]

    return get


@pytest.mark.parametrize("logn,klog", [(6, 9), (6, 2), (6, 1), (10, 4)])
def test_plans_match_reference_ntt_plan(ref_ntt, logn, klog):
    """The port's FusedNTT at (logn, klog) — one level, three, six, and
    three of 2^4, 2^3, 2^3 points — forward and inverse against blaze_tpu's
    NTTPlan, on K9 at every twiddle (the K8 threshold lowered; the K8
    fallback runs in the test above)."""
    plan = FusedNTT(SPEC, logn, klog=klog, device="cpu")
    plan._TWMUL_MIN_LANES = 1
    assert len(plan.parts) == -(-logn // klog)
    x, fwd, inv = (a[0] for a in ref_ntt(logn))
    xt = as_t(x)
    got = plan.ntt(xt)
    assert torch.equal(got, as_t(fwd)) and torch.equal(plan.intt(xt), as_t(inv))
    assert torch.equal(plan.intt(got), xt)


@pytest.mark.parametrize("cls", [NTTPlan, FourStepNTT])
def test_batched_plans_match_reference(ref_ntt, cls):
    """NTTPlan (pieces of 2 and 1 transforms) and FourStepNTT on (3, n, W),
    both ways, against blaze_tpu's NTTPlan; make_ntt is the fused plan."""
    logn = 6
    x, fwd, inv = ref_ntt(logn)
    plan = cls(SPEC, logn, device="cpu")
    xt = as_t(x)
    assert torch.equal(plan.ntt(xt), as_t(fwd)) and torch.equal(plan.intt(xt), as_t(inv))
    assert isinstance(make_ntt(SPEC, logn, device="cpu"), FusedNTT)


@pytest.fixture(scope="module")
def dist_groups(ref_ntt, tmp_path_factory):
    """DistributedNTT at logn 6 (logn1 3) on every rank of gloo groups of 4
    and 2 (spawned) and 1 (this process, while the others run)."""
    logn = 6
    x = ref_ntt(logn)[0]
    case = {"kind": "ntt", "field": FIELD, "logn": logn, "logn1": 3, "x": x[0]}
    started = {world: start_ranks(world, {"ntt": {**case, "mesh": {"sp": world}}},
                                  tmp_path_factory.mktemp(f"wide{world}"))
               for world in (4, 2)}
    try:
        one = CASES["ntt"]({**case, "mesh": {"sp": 1}})
    finally:
        dist.destroy_process_group()
    out = {world: [r["ntt"] for r in join_ranks(g)] for world, g in started.items()}
    out[1] = [one]
    return out


@pytest.mark.parametrize("D", [1, 2, 4])
def test_distributed_ntt_matches_reference(ref_ntt, dist_groups, D):
    """Each rank's k-matrix shard of JAX's (n1, n2) layout, the gathered
    natural-order spectrum and the inverse, against blaze_tpu's NTTPlan."""
    x, fwd, _ = ref_ntt(6)
    n1 = 8
    kmat = fwd[0].reshape(-1, n1, W).transpose(1, 0, 2)     # [k1, k2] = X[k1 + n1 k2]
    ranks = dist_groups[D]
    assert len(ranks) == D
    for r, got in enumerate(ranks):
        rows = n1 // D
        assert np.array_equal(got["shard"], kmat[r * rows:(r + 1) * rows])
        assert np.array_equal(got["natural"], fwd[0])
        assert np.array_equal(got["back"], x[0])


# ------------------------------------------------------------------ client
def test_client_matches_reference_client():
    """NTTClient(device="cpu") on bls12_377_fq at logn 6, forward and
    inverse, byte for byte against blaze_tpu's client: wire bytes of 48 B
    per element, the reference's (n, 24) limbs and (n, 12) words in."""
    logn = 6
    n = 1 << logn
    x = rand_words((n,), 50)
    raw = x.astype("<u4").tobytes()
    assert len(raw) == 48 * n
    fwd = NTTClient(NTTInit(field=FIELD, logn=logn), device="cpu")
    inv = NTTClient(NTTInit(field=FIELD, logn=logn), device="cpu", inverse=True)
    assert fwd.loaded_binary_parameters().fields["element_bytes"] == 48
    ref = RefNTTClient(RefNTTInit(field=FIELD, logn=logn))
    ref.set_data(RefNTTInput(data=raw))
    ref.start_process()
    ref.wait_result()
    want = ref.result()
    outs = []
    for data in (raw, limbs(x), x):
        fwd.set_data(NTTInput(data=data))
        fwd.start_process()
        fwd.wait_result()
        outs.append(fwd.result())
    assert outs == [want] * 3
    inv.set_data(NTTInput(data=want, buf_host=1))
    inv.start_process(1)
    inv.wait_result(1)
    assert inv.result(1) == raw
