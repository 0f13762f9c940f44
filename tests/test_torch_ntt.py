"""The port's NTT (blaze_tpu_torch.ntt and NTTClient) against the JAX package,
on the CPU (the plain versions of the kernels).

Same inputs, made with seeded numpy, go through blaze_tpu's Pallas NTT
kernels in interpret mode, its FusedNTT (interpret mode) and NTTPlan, its
NTTClient and its Field.powers, and through the port's plain versions of
K7-K9, FusedNTT and NTTClient(device="cpu").  Everything is integer
arithmetic: every comparison is exact.  The client is also held to every
committed golden pair (tests/fixtures/ntt_*, produced outside both
packages by scripts/gen_ntt_vectors.py).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu.ntt import (
    FusedNTT as RefFusedNTT,
    NTTKernels as RefNTTKernels,
    NTTPlan,
    split_parts as ref_split_parts,
)
from blaze_tpu.runtime import (
    NTTClient as RefNTTClient,
    NTTInit as RefNTTInit,
    NTTInput as RefNTTInput,
)
from blaze_tpu_torch.fields import FIELDS, Field, FieldSpec, int_to_words
from blaze_tpu_torch.ntt import (
    FusedNTT,
    NTTKernels,
    make_ntt,
    split_parts,
    tables_from_reference,
)
from blaze_tpu_torch.ntt.fused import plan_levels, plan_parts
from blaze_tpu_torch.ntt.kernels import MAX_FIELDS, TileMap, twiddle_cols
from blaze_tpu_torch.runtime import NTTClient, NTTInit, NTTInput
from blaze_tpu_torch.utils import DataError, DeviceError, InvalidPrimitiveParam, NotReady

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXDIR = REPO / "tests" / "fixtures"
TWO_FIELDS = ("bls12_381_fr", "bn254_fr")


def rand_words(spec, shape, seed: int) -> np.ndarray:
    """(*shape, W) uint32 words of random values below 2^(bits-1) < p."""
    w = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(*shape, spec.nwords), dtype=np.uint32
    )
    w[..., -1] &= (1 << (spec.bits - 1 - 32 * (spec.nwords - 1))) - 1
    return w


def as_t(w: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.uint32).view(np.int32))


def limbs(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> (..., L) 16-bit limbs as uint32."""
    return np.ascontiguousarray(w, dtype=np.uint32).view("<u2").astype(np.uint32)


def lm(w: np.ndarray):
    """(R, N, W) words -> the port's (R, W, N) tensor and the JAX
    package's (R, L, N) limbs."""
    return as_t(w.transpose(0, 2, 1).copy()), jnp.asarray(np.moveaxis(limbs(w), -1, 1))


def ref_words(a) -> torch.Tensor:
    """The JAX package's (R, L, N) limbs -> (R, W, N) int32 words."""
    pm = np.moveaxis(np.asarray(a).astype("<u2"), 1, -1).copy().view("<u4")
    return as_t(np.moveaxis(pm, -1, 1).copy())


def wire(w: np.ndarray) -> bytes:
    return np.ascontiguousarray(w, dtype="<u4").tobytes()


# ------------------------------------------------------------------ kernels
# K7's layouts: (K, B) rows, and two levels of plans over 2^10 points whose
# K = 8 levels have 128 lanes: level 0 of [3, 4, 3] (natural input, the
# output's lane digits reversed, out of place) and level 1 of [3, 3, 4]
# (two lane digits, in place).
NTT_LAYOUTS = {
    "rows": None,
    "level0_of_343": plan_levels([3, 4, 3])[0],
    "level1_of_334": plan_levels([3, 3, 4])[1],
}


@pytest.mark.parametrize("layout", sorted(NTT_LAYOUTS))
def test_ntt_base_plain_matches_pallas_kernel(layout):
    """K7: natural-order input read through the layout's map (the port
    folds the bit-reversal into the kernel) against the JAX kernel fed the
    same lanes' bit-reversed rows; the output read back through the output
    map."""
    field = "bls12_381_fr"
    spec = FIELDS[field]
    K, B = 8, 128
    lv = NTT_LAYOUTS[layout]
    xmap = TileMap.rows(B) if lv is None else lv.xmap
    omap = xmap if lv is None else lv.omap
    assert lv is None or (1 << lv.a, lv.lanes) == (K, B)
    x = rand_words(spec, (K * B,), 1)
    pack = rand_words(spec, (K,), 2)
    pack[[0, 1, 3]] = int_to_words(spec.r % spec.p, spec.nwords)    # W^0 = 1 at m - 1
    rows = xmap.offsets(K, B, "cpu").numpy()
    rev = [0, 4, 2, 6, 1, 5, 3, 7]
    _, xref = lm(x[rows[rev]])
    packref = jnp.asarray(np.broadcast_to(limbs(pack)[:, :, None], (K, 16, 128)).astype(np.uint16))
    want = RefNTTKernels.for_spec(REF_FIELDS[field], interpret=True).ntt_base(xref, packref)
    k = NTTKernels.for_spec(spec)
    xt = as_t(x)
    in_place = lv is not None and lv.xmap == lv.omap
    got = k.ntt_base(xt, as_t(pack), B, xmap, out=xt if in_place else None, omap=omap)
    assert (got is xt) == in_place
    out_rows = omap.offsets(K, B, "cpu")
    assert torch.equal(got[out_rows].transpose(1, 2), ref_words(want))


@pytest.mark.parametrize("operands", [2, 3])
def test_mul_lm_plain_matches_pallas_kernel(operands):
    spec = FIELDS["bls12_381_fr"]
    ops = [lm(rand_words(spec, (2, 128), 10 + i)) for i in range(operands)]
    want = RefNTTKernels.for_spec(REF_FIELDS[spec.name], interpret=True).mul_lm(
        *[r for _, r in ops])
    got = NTTKernels.for_spec(spec).mul_lm(*[t for t, _ in ops])
    assert torch.equal(got, ref_words(want))


@pytest.mark.parametrize("A,J,S,B", [(4, 4, 8, 1), (4, 2, 4, 8)])
def test_twiddle_mul_plain_matches_pallas_kernel(A, J, S, B):
    """K9, both branches of the JAX kernel: B = 1 (depth-0 cells) and
    B > 1.  The port's rows are the JAX package's (A, J*S*B) lanes as
    (A*J*S*B, W) elements: row v * lanes + j * B + b, so v is the row's
    bits from log2(lanes) and j its bits from log2(B)."""
    spec = FIELDS["bls12_381_fr"]
    lanes = J * S * B
    yw = rand_words(spec, (A, lanes), 20)
    _, yref = lm(yw)
    t1w, t2w = rand_words(spec, (A, J), 21), rand_words(spec, (A, S), 22)
    (_, t1ref), (_, t2ref) = lm(t1w), lm(t2w)
    t1, t2 = as_t(t1w), as_t(t2w)                      # (A, J, W), (A, S, W) elements
    want = RefNTTKernels.for_spec(REF_FIELDS[spec.name], interpret=True).twiddle_mul(
        yref, t1ref, t2ref, B)
    want = ref_words(want).transpose(1, 2).reshape(A * lanes, spec.nwords)
    k = NTTKernels.for_spec(spec)
    vshift, fields = lanes.bit_length() - 1, ((B.bit_length() - 1, (J * S).bit_length() - 1, 0),)
    y = as_t(yw.reshape(A * lanes, spec.nwords))
    assert torch.equal(k.twiddle_mul(y, t1, t2, vshift, fields), want)
    inplace = y.clone()
    assert k.twiddle_mul(inplace, t1, t2, vshift, fields, out=inplace) is inplace
    assert torch.equal(inplace, want)


def test_kernel_wrappers_check_their_operands():
    spec = FIELDS["bn254_fr"]
    k = NTTKernels.for_spec(spec)
    x = as_t(rand_words(spec, (32,), 3))
    pack = as_t(rand_words(spec, (8,), 4))
    with pytest.raises(ValueError):
        k.ntt_base(x, pack[:6].contiguous())                        # K not a power of two
    with pytest.raises(ValueError):
        k.ntt_base(x.reshape(8, 8, 4), pack)                        # not (N, W)
    with pytest.raises(ValueError):
        k.ntt_base(x, pack, 8)                                      # 8 lanes of 8 > 32 rows
    with pytest.raises(ValueError):
        k.ntt_base(x, pack, 4, out=x, omap=TileMap.lanes_at(1, 3))     # in place, other map
    with pytest.raises(ValueError):
        k.ntt_base(x, pack, 4, omap=TileMap.lanes_at(8))           # out reaches past 32 rows
    lm3 = x.reshape(4, 8, 8)
    with pytest.raises(ValueError):
        k.mul_lm(lm3, lm3[:2].contiguous())
    t = x.reshape(4, 8, 8)[:, :4].contiguous()
    with pytest.raises(ValueError):
        k.twiddle_mul(x, t, t[:, :3].contiguous(), 0, ())           # S not a power of two
    with pytest.raises(ValueError):
        k.twiddle_mul(x, t, t, 0, ((0, 5, 0),))                     # j reaches past J*S
    assert NTTKernels(FIELDS["bls12_381_fq"]).W == 12        # built at W = 8 and 12
    with pytest.raises(ValueError, match="words"):
        NTTKernels(FieldSpec("m61", (1 << 61) - 1))               # W = 2


# ------------------------------------------------------------ field powers
def test_powers_match_reference():
    field = "bls12_377_fr"
    spec = FIELDS[field]
    b = spec.root_of_unity(7)
    bm = (b * spec.r) % spec.p
    got = Field(spec).powers(as_t(int_to_words(bm, spec.nwords)), 37)
    want = RefField(REF_FIELDS[field]).powers(
        jnp.asarray(limbs(int_to_words(bm, spec.nwords))), 37)
    assert torch.equal(got, as_t(np.asarray(want, np.uint32).astype("<u2").view("<u4")))
    assert Field(spec).powers(got[1], 1).shape == (1, spec.nwords)


# ------------------------------------------------------------- fused plan
@pytest.fixture(scope="module")
def ref_plans():
    """blaze_tpu FusedNTT plans (interpret mode), built once per case."""
    cache = {}

    def get(field, logn, klog):
        key = (field, logn, klog)
        if key not in cache:
            plan = RefFusedNTT(REF_FIELDS[field], logn, klog=klog, interpret=True)
            plan._TWMUL_MIN_LANES = 1       # the K9 path at small sizes
            cache[key] = plan
        return cache[key]

    return get


@pytest.mark.parametrize("field", TWO_FIELDS)
@pytest.mark.parametrize("logn,klog", [(9, 3), (6, 3)])
def test_fused_matches_reference_plans(field, logn, klog, ref_plans):
    """Tables bit for bit, `_base`, forward and inverse against blaze_tpu's
    portable NTTPlan and, at logn 9, its FusedNTT in interpret mode.  logn 9
    runs K9 on both branches (the threshold lowered as
    tests/test_ntt_fused.py does); logn 6 takes the K8 fallback."""
    spec = FIELDS[field]
    ref = ref_plans(field, logn, klog)
    plan = FusedNTT(spec, logn, klog=klog, device="cpu")
    if logn == 9:
        plan._TWMUL_MIN_LANES = 1
    assert plan.parts == ref.parts == split_parts(logn, klog)

    packs, tabs = tables_from_reference(
        {k: np.asarray(v) for k, v in ref._packs.items()},
        {k: tuple(np.asarray(t) for t in v) for k, v in ref._tabs.items()},
    )
    assert sorted(packs) == sorted(plan._packs) and sorted(tabs) == sorted(plan._tabs)
    for k, v in packs.items():
        assert torch.equal(plan._packs[k], v), k
    for k, (t1, t2) in tabs.items():
        assert torch.equal(plan._tabs[k][0], t1) and torch.equal(plan._tabs[k][1], t2), k

    x = rand_words(spec, (1 << logn,), logn)
    a = plan.parts[0]
    _, xbref = lm(x.reshape(1 << a, -1, spec.nwords))
    base = plan.kern.ntt_base(as_t(x), plan._packs[(a, True)])     # (A, C) rows
    want = ref_words(ref._base(xbref, a, True)).transpose(1, 2).reshape(-1, spec.nwords)
    assert torch.equal(base, want)

    xt, xl = as_t(x), jnp.asarray(limbs(x))
    fwd, inv = plan.ntt(xt), plan.intt(xt)
    assert torch.equal(xt, as_t(x))                    # the input is left as it was
    portable = NTTPlan(REF_FIELDS[field], logn)
    for got, r_fused, r_plain in ((fwd, ref.ntt, portable.ntt), (inv, ref.intt, portable.intt)):
        want = np.asarray(r_plain(xl), np.uint32)
        assert np.array_equal(limbs(got.numpy().view(np.uint32)), want)
        if logn == 9:
            assert np.array_equal(np.asarray(r_fused(xl), np.uint32), want)
    assert torch.equal(plan.intt(fwd), xt)


@pytest.mark.parametrize("field", TWO_FIELDS)
def test_small_plan_twiddles_are_cached_products_on_one_k8_call(field, monkeypatch):
    """The K8 fallback at logn 10 (parts 5, 5: a twiddle cell of 8 lanes,
    under _TWMUL_MIN_LANES as it is): the plan keeps, per direction, the
    element-order twiddles tab1[v, jo] * tab2[v, jl] built once, and each
    transform makes one mul_lm call of two operands on them, in place;
    forward and inverse equal blaze_tpu's NTTPlan."""
    spec = FIELDS[field]
    plan = FusedNTT(spec, 10, device="cpu")
    assert plan.parts == [5, 5] and plan._takes_k8(0)
    lv = plan.levels[0]
    for inv in (False, True):
        tab1, tab2 = plan._tabs[(0, inv)]
        v, jo, jl = twiddle_cols(plan.n, lv.a, lv.vshift, lv.fields,
                                 tab2.shape[1].bit_length() - 1, "cpu")
        rows = plan._twiddle_rows(0, inv)
        assert rows.shape == (plan.n, spec.nwords)
        assert torch.equal(rows, Field(spec).mul(tab1[v, jo], tab2[v, jl]))
    calls = []
    mul_lm = plan.kern.mul_lm

    def recording(x, y, z=None, out=None):
        calls.append((z is None, out is x, y.data_ptr()))
        return mul_lm(x, y, z, out)

    monkeypatch.setattr(plan.kern, "mul_lm", recording)
    x = rand_words(spec, (plan.n,), 11)
    xt, xl = as_t(x), jnp.asarray(limbs(x))
    fwd, inv = plan.ntt(xt), plan.intt(xt)
    assert calls == [(True, True, plan._twiddle_rows(0, d).data_ptr()) for d in (False, True)]
    portable = NTTPlan(REF_FIELDS[field], 10)
    assert np.array_equal(limbs(fwd.numpy().view(np.uint32)), np.asarray(portable.ntt(xl)))
    assert np.array_equal(limbs(inv.numpy().view(np.uint32)), np.asarray(portable.intt(xl)))


def test_plan_factory_and_sizes():
    spec = FIELDS["bn254_fr"]
    for logn, klog in ((27, 9), (22, 9), (20, 9), (16, 9), (9, 9), (0, 9), (7, 3)):
        assert split_parts(logn, klog) == ref_split_parts(logn, klog)
    plan = make_ntt(spec, 4, device="cpu")
    assert isinstance(plan, FusedNTT) and plan.parts == [4]
    x = as_t(rand_words(spec, (16,), 4))
    assert torch.equal(plan.intt(plan.ntt(x)), x)
    one = FusedNTT(spec, 0, device="cpu")
    assert torch.equal(one.ntt(x[:1]), x[:1])
    with pytest.raises(ValueError):
        FusedNTT(spec, spec.two_adicity + 1, device="cpu")
    with pytest.raises(ValueError):
        plan.ntt(x[:8])


@pytest.mark.parametrize("logn,klog", [(8, 1), (15, 2), (22, 3)])
def test_fused_refuses_plans_past_k7s_maps(logn, klog):
    """Plans whose balanced split at klog takes more than MAX_FIELDS + 1 = 7
    levels (level 0's maps hold one lane field per later level) are built,
    no longer refused: they run logn split into 7 parts (plan_parts), whose
    level 0 fills all six of its maps' lane fields.  (8, 1) equals
    blaze_tpu's NTTPlan, forward and inverse; (15, 2) equals the port's
    klog-9 plan of the same size; (22, 3), too large for the plain versions,
    is held to the klog-9 plan on the card (tests/test_torch_cuda.py).  At
    klog 9 the deepest plan, bls12_377_fr at its 2-adicity 47, has 6
    levels."""
    spec = FIELDS["bls12_377_fr"]
    assert len(split_parts(logn, klog)) == MAX_FIELDS + 2 == len(ref_split_parts(logn, klog))
    deep = FusedNTT(spec, logn, klog=klog, device="cpu")
    assert deep.parts == plan_parts(logn, klog) and len(deep.parts) == MAX_FIELDS + 1
    assert sum(deep.parts) == logn and max(deep.parts) - min(deep.parts) <= 1
    assert len(deep.levels) == 7 and len(deep.levels[0].omap.fields) == MAX_FIELDS
    assert len(split_parts(spec.two_adicity, 9)) == 6
    x = rand_words(spec, (1 << logn,), logn)
    xt = as_t(x)
    if klog == 1:
        portable = NTTPlan(REF_FIELDS[spec.name], logn)
        xl = jnp.asarray(limbs(x))
        for got, want in ((deep.ntt(xt), portable.ntt(xl)), (deep.intt(xt), portable.intt(xl))):
            assert np.array_equal(limbs(got.numpy().view(np.uint32)), np.asarray(want))
    elif klog == 2:
        flat = FusedNTT(spec, logn, device="cpu")
        assert flat.parts == [8, 7]
        assert torch.equal(deep.ntt(xt), flat.ntt(xt))


# ------------------------------------------------------------------ client
def _committed_fixtures():
    out = []
    for inf in sorted(FIXDIR.glob("ntt_*_2e*.in")):
        m = re.match(r"ntt_(.+)_2e(\d+)\.in$", inf.name)
        if m and inf.with_suffix(".out").exists():
            out.append((m.group(1), int(m.group(2)), inf, inf.with_suffix(".out")))
    return out


@pytest.mark.parametrize("field,logn,inf,outf", _committed_fixtures(),
                         ids=[f"{f}_2e{n}" for f, n, _, _ in _committed_fixtures()])
def test_client_matches_committed_goldens(field, logn, inf, outf):
    raw, want = inf.read_bytes(), outf.read_bytes()
    client = NTTClient(NTTInit(field=field, logn=logn), device="cpu")
    client.initialize()
    client.set_data(NTTInput(data=raw))
    client.start_process()
    client.wait_result()
    assert client.result() == want
    inv = NTTClient(NTTInit(field=field, logn=logn), device="cpu", inverse=True)
    inv.set_data(NTTInput(data=want, buf_host=1))
    inv.start_process(1)
    inv.wait_result(1)
    assert inv.result(1) == raw


def test_client_pipelined_order_matches_reference_client():
    """The reference's double-buffered order (integration_ntt.rs:103-136:
    start the kernel on one slot, drain and refill the other, wait) over
    three vectors; every output equals blaze_tpu's client bytes, and the
    inverse client brings each back to its input."""
    field, logn = "bn254_fr", 6
    spec = FIELDS[field]
    raws = [wire(rand_words(spec, (1 << logn,), 40 + i)) for i in range(3)]
    client = NTTClient(NTTInit(field=field, logn=logn), device="cpu")
    inv = NTTClient(NTTInit(field=field, logn=logn), device="cpu", inverse=True)
    img = client.loaded_binary_parameters()
    assert img.fields["element_bytes"] == 32 and img.fields["buffers"] == 2
    outs = {}
    for i in range(len(raws) + 2):
        host, kern = i % 2, 1 - i % 2
        if 1 <= i <= len(raws):
            client.start_process(kern)
            assert client.get_api()["buffers"][kern] == "busy"
        if i >= 2:
            outs[i - 2] = client.result(host)
        if i < len(raws):
            client.set_data(NTTInput(data=raws[i], buf_host=host))
            assert client.get_api()["buffers"][host] == "staged"
        client.wait_result(kern)
    assert client.pending_tasks == 0 and client.result(0) is None

    ref = RefNTTClient(RefNTTInit(field=field, logn=logn))
    for i, raw in enumerate(raws):
        ref.set_data(RefNTTInput(data=raw))
        ref.start_process()
        ref.wait_result()
        assert outs[i] == ref.result()
        inv.set_data(NTTInput(data=outs[i]))
        inv.start_process()
        inv.wait_result()
        assert inv.result() == raw


def test_client_accepts_words_and_checks_its_input():
    field, logn = "bls12_381_fr", 4
    spec = FIELDS[field]
    w = rand_words(spec, (1 << logn,), 50)
    client = NTTClient(NTTInit(field=spec, logn=logn), device="cpu")
    with pytest.raises(NotReady):
        client.start_process(0)                          # empty slot
    with pytest.raises(DataError):
        client.set_data(NTTInput(data=wire(w)[:-1]))     # not whole elements
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(NTTInput(data=wire(w)[:-32]))    # one element short
    with pytest.raises(DataError):
        client.set_data(NTTInput(data=w[:, :4]))         # not (n, W) words
    assert client.result(1) is None
    client.set_data(NTTInput(data=w))
    client.start_process()
    with pytest.raises(NotReady):
        client.start_process()                           # the input was consumed
    client.wait_result()
    via_words = client.result()
    client.set_data(NTTInput(data=bytearray(wire(w))))
    client.start_process()
    assert client.result() == via_words
    api = client.get_api()
    assert api["buffers"] == {0: "empty", 1: "empty"} and api["pending_tasks"] == 0


def test_client_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(DeviceError):
        NTTClient(NTTInit(field="bls12_381_fr", logn=4))


def test_cpu_ntt_client_loads_no_jax():
    code = (
        "import sys\n"
        "from blaze_tpu_torch.runtime import NTTClient, NTTInit, NTTInput\n"
        "raw = open('tests/fixtures/ntt_bn254_fr_2e6.in', 'rb').read()\n"
        "c = NTTClient(NTTInit(field='bn254_fr', logn=6), device='cpu')\n"
        "c.set_data(NTTInput(data=raw))\n"
        "c.start_process()\n"
        "assert c.result() == open('tests/fixtures/ntt_bn254_fr_2e6.out', 'rb').read()\n"
        "assert 'jax' not in sys.modules and 'blaze_tpu' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
