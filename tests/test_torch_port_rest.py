"""The port's last modules against the JAX package, on the CPU: the mesh of
DeviceContext and blaze_tpu_torch.dist, the Curve methods the JAX package
computes outside any Pallas kernel (is_identity, select, add_mixed,
on_curve, scalar_mul), and the host codec (native/codec.py on
csrc/codec.cpp, built here with g++).

Curve inputs are order-r subgroup points of the port's oracle from a seed,
in Montgomery words; the JAX package gets the same values as 16-bit limbs.
The codec is held to blaze_tpu.native.codec (whichever path it takes) and
to the committed goldens tests/fixtures/codec_*.bin, which
scripts/gen_codec_goldens.py made outside both packages.  Then the public
names that blaze_tpu has beside those modules: native.have_native,
Field.double and Field.eq, Curve.nlimbs and MSMConfig.windows.  Every
comparison is exact.
"""
import random
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import jax
import jax.numpy as jnp

import blaze_tpu.native as ref_native
from blaze_tpu.curves import CURVES as REF_CURVES, Curve as RefCurve
from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu.msm import MSMConfig as RefMSMConfig
from blaze_tpu.native import codec as ref_codec
import blaze_tpu_torch.native as native
from blaze_tpu_torch import _build
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.dist import init_distributed, make_mesh, replicated, shard_leading
from blaze_tpu_torch.fields import FIELDS, Field
from blaze_tpu_torch.fields import codec as field_codec
from blaze_tpu_torch.msm import MSMConfig
from blaze_tpu_torch.native import codec
from blaze_tpu_torch.oracle import ECOracle
from blaze_tpu_torch.oracle.gen import points_to_affine_words
from blaze_tpu_torch.runtime import DeviceContext
from blaze_tpu_torch.utils import DeviceError, LoadFailed

torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"


def limbs(w: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> (..., L) 16-bit limbs as uint32."""
    return np.ascontiguousarray(w, dtype=np.uint32).view("<u2").astype(np.uint32)


# ------------------------------------------------------------------ the mesh
@pytest.fixture
def single_rank():
    """A process group of one (made by make_mesh), destroyed afterwards."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_num_devices_on_the_cpu():
    assert DeviceContext(device="cpu").num_devices == 1


def test_make_mesh_names_its_axes_and_refuses_too_many_ranks(single_rank):
    """DeviceContext.make_mesh gives a DeviceMesh over a group of one, named
    by the dict's keys; a mesh of more ranks than the group has raises
    ValueError, as blaze_tpu/runtime/device.py:62-64 does for devices."""
    ctx = DeviceContext(device="cpu")
    init_distributed(None)                         # a single process: no-op
    assert not dist.is_initialized()
    mesh = ctx.make_mesh({"dp": 1, "sp": 1})
    assert mesh.mesh_dim_names == ("dp", "sp") and tuple(mesh.shape) == (1, 1)
    assert make_mesh({"sp": 1}, device_type="cpu").mesh_dim_names == ("sp",)
    with pytest.raises(ValueError, match="wants 2 ranks"):
        ctx.make_mesh({"dp": 2})
    with pytest.raises(ValueError, match="wants 4 ranks"):
        make_mesh({"dp": 2, "sp": 2}, device_type="cpu")


def test_placements_shard_the_leading_dimension(single_rank):
    """shard_leading / replicated are the DTensor placements of JAX's
    P(axis) / P() and lay a tensor out as such."""
    mesh = make_mesh({"dp": 1, "sp": 1}, device_type="cpu")
    assert shard_leading(mesh, "dp") == (Shard(0), Replicate())
    assert shard_leading(mesh, "sp") == (Replicate(), Shard(0))
    assert replicated(mesh) == (Replicate(), Replicate())
    t = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    d = distribute_tensor(t, mesh, shard_leading(mesh, "dp"))
    assert torch.equal(d.to_local(), t) and torch.equal(d.full_tensor(), t)
    with pytest.raises(ValueError):
        shard_leading(mesh, "tp")


def test_a_cuda_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        make_mesh({"dp": 1})
    assert not dist.is_initialized()


# ---------------------------------------------------------- Curve methods
def curve_case(name: str, seed: int = 5):
    """Port Curve, JAX Curve, oracle, 4 subgroup points as ints and as
    Montgomery affine words (4, 2, W)."""
    spec = CURVES[name]
    cv, ref = Curve(spec), RefCurve(REF_CURVES[name])
    oracle = ECOracle(spec)
    rng = random.Random(seed)
    pts = [oracle.random_subgroup_point(rng) for _ in range(4)]
    aff = cv.fq.to_mont(torch.from_numpy(points_to_affine_words(spec, pts).view(np.int32)))
    return cv, ref, oracle, pts, aff


def affine_ints(cv: Curve, p: torch.Tensor):
    """(B, 3, W) projective -> [(x, y)] ints; None for the identity."""
    out = []
    for X, Y, Z in (cv.fq.to_int(row) for row in p):
        zi = pow(Z, -1, cv.spec.fq.p) if Z else None
        out.append(None if zi is None else (X * zi % cv.spec.fq.p, Y * zi % cv.spec.fq.p))
    return out


def ref_affine_ints(ref: RefCurve, p) -> list:
    return [None if Z == 0 else (X * pow(Z, -1, ref.spec.fq.p) % ref.spec.fq.p,
                                 Y * pow(Z, -1, ref.spec.fq.p) % ref.spec.fq.p)
            for X, Y, Z in ref.fq.to_int(p)]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_on_curve_matches_jax(name):
    """on_curve: true for subgroup points and the identity, false for a
    point with one bit of Y flipped; equal to blaze_tpu's Curve.on_curve."""
    cv, ref, _, _, aff = curve_case(name)
    P = torch.cat([cv.from_affine(aff), cv.identity((1,))])
    bad = P.clone()
    bad[1, 1, 0] ^= 1
    P = torch.cat([P, bad[1:2]])
    got = cv.on_curve(P)
    assert got.tolist() == [True] * 5 + [False]
    want = ref.on_curve(jnp.asarray(limbs(P.numpy().view(np.uint32))))
    assert np.asarray(want).tolist() == got.tolist()


@pytest.mark.parametrize("name", sorted(CURVES))
def test_add_mixed_matches_add_and_the_oracle(name):
    """add_mixed(Q, A) equals add(Q, from_affine(A)) and the oracle's 2B + A,
    in affine ints, on bn254 also blaze_tpu's add_mixed (jitted: one
    compile; its eager ops compile one by one, ~12 s a curve here); the
    identity plus A is A."""
    cv, ref, oracle, pts, aff = curve_case(name)
    Q = cv.dbl(cv.from_affine(aff.flip(0)))
    got = affine_ints(cv, cv.add_mixed(Q, aff))
    assert got == affine_ints(cv, cv.add(Q, cv.from_affine(aff)))
    assert got == [oracle.add(oracle.dbl(b), a) for a, b in zip(pts, pts[::-1])]
    if name == "bn254":
        want = jax.jit(ref.add_mixed)(jnp.asarray(limbs(Q.numpy().view(np.uint32))),
                                      jnp.asarray(limbs(aff.numpy().view(np.uint32))))
        assert got == ref_affine_ints(ref, want)
    assert affine_ints(cv, cv.add_mixed(cv.identity((4,)), aff)) == pts


@pytest.mark.parametrize("name", sorted(CURVES))
def test_is_identity_and_select(name):
    cv, _, _, _, aff = curve_case(name)
    P = cv.from_affine(aff)
    both = torch.stack([P[0], cv.identity()])
    assert cv.is_identity(both).tolist() == [False, True]
    pick = cv.select(torch.tensor([True, False, False, True]), P, cv.neg(P))
    assert torch.equal(pick[0], P[0]) and torch.equal(pick[1], cv.neg(P)[1])


@pytest.mark.parametrize("name", sorted(CURVES))
def test_scalar_mul_matches_oracle(name):
    """scalar_mul by 0, 5 and r - 1 over 4 points equals ECOracle.mul."""
    cv, _, oracle, pts, aff = curve_case(name)
    P = cv.from_affine(aff)
    for k in (0, 5, cv.spec.fr.p - 1):
        got = cv.scalar_mul(P, k)
        assert affine_ints(cv, got) == [oracle.mul(pt, k) for pt in pts], k
        assert cv.on_curve(got).all()


# -------------------------------------------------------------- the codec
def goldens() -> dict:
    return {name: (FIXDIR / f"codec_{name}.bin").read_bytes()
            for name in ("input", "banks", "transposed")}


def test_codec_matches_goldens():
    """The port's host codec against the committed goldens
    (tests/test_native.py:58 checks the JAX package's against the same):
    1024 elements of 32 B, 16 banks, a (16, 64) transpose, the limbs."""
    g = goldens()
    data = g["input"]
    banks = codec.bank_split(data, 32, 16)
    assert b"".join(banks) == g["banks"]
    assert codec.bank_merge(banks, 32) == data
    assert codec.transpose(data, 16, 64, 32) == g["transposed"]
    got = codec.bytes_to_limbs(data, 32)
    assert np.array_equal(got, np.frombuffer(data, dtype="<u2").reshape(1024, 16))
    assert codec.limbs_to_bytes(got, 32) == data


@pytest.mark.parametrize("elem", [32, 48])
def test_codec_matches_blaze_tpu(elem):
    """Every function against blaze_tpu.native.codec on random bytes."""
    rng = np.random.default_rng(elem)
    data = rng.integers(0, 256, size=96 * elem, dtype=np.uint8).tobytes()
    got = codec.bytes_to_limbs(data, elem)
    assert np.array_equal(got, ref_codec.bytes_to_limbs(data, elem))
    assert codec.limbs_to_bytes(got, elem) == ref_codec.limbs_to_bytes(got, elem) == data
    assert codec.bank_split(data, elem, 8) == ref_codec.bank_split(data, elem, 8)
    banks = ref_codec.bank_split(data, elem, 8)
    assert codec.bank_merge(banks, elem) == ref_codec.bank_merge(banks, elem)
    assert codec.transpose(data, 12, 8, elem) == ref_codec.transpose(data, 12, 8, elem)


def test_field_codec_takes_the_host_codec_above_the_threshold():
    """fields/codec.py from _NATIVE_MIN_BYTES up (the JAX package's 4 MiB)
    equals its numpy path below it."""
    spec = FIELDS["bls12_381_fr"]
    n = field_codec._NATIVE_MIN_BYTES // spec.nbytes
    data = np.random.default_rng(2).integers(0, 256, size=n * spec.nbytes,
                                             dtype=np.uint8).tobytes()
    big = field_codec.bytes_to_limbs(data, spec)
    small = np.concatenate([field_codec.bytes_to_limbs(data[i:i + (1 << 20)], spec)
                            for i in range(0, len(data), 1 << 20)])
    assert np.array_equal(big, small)
    assert field_codec.limbs_to_bytes(np.concatenate([big, big]), spec) == data + data


def test_a_failed_codec_build_raises(monkeypatch, tmp_path):
    """A compiler that fails raises LoadFailed; nothing drops to numpy."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    monkeypatch.delitem(_build._LIBS, "codec", raising=False)
    with pytest.raises(LoadFailed, match="codec"):
        codec.bytes_to_limbs(bytes(64), 32)
    assert not list(tmp_path.rglob("libcodec.so"))


# --------------------------------------------------------- public names
def test_have_native_probes_the_build(monkeypatch, tmp_path):
    """native.have_native, exported as blaze_tpu.native exports it: a bool,
    True where g++ builds the codec, and False (not LoadFailed) where the
    build fails."""
    assert "have_native" in native.__all__ and "have_native" in ref_native.__all__
    assert isinstance(ref_native.have_native(), bool)
    assert native.have_native() is True
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    monkeypatch.delitem(_build._LIBS, "codec", raising=False)
    assert native.have_native() is False


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_381_fq"])
def test_field_double_and_eq_match_jax(field):
    """Field.double and Field.eq against blaze_tpu's on the same values:
    random ones, p - 1, 0 and pairs that differ in one word."""
    spec = FIELDS[field]
    rng = np.random.default_rng(5)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=6)]
    vals = [v * (spec.p // (1 << 62)) % spec.p for v in vals] + [spec.p - 1, 0]
    a = np.stack([np.frombuffer(v.to_bytes(4 * spec.nwords, "little"), "<u4") for v in vals])
    b = a.copy()
    b[::2, 0] ^= 1
    f, ref = Field(spec), RefField(REF_FIELDS[field])
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    got = f.double(ta).numpy().view(np.uint32)
    assert np.array_equal(limbs(got), np.asarray(ref.double(jnp.asarray(limbs(a)))))
    assert [words_int(r) for r in got] == [2 * v % spec.p for v in vals]
    want_eq = np.asarray(ref.eq(jnp.asarray(limbs(a)), jnp.asarray(limbs(b))))
    assert f.eq(ta, tb).tolist() == want_eq.tolist() == [False, True] * 4


def words_int(row) -> int:
    return int.from_bytes(np.asarray(row, "<u4").tobytes(), "little")


def test_curve_nlimbs_and_msm_windows_match_jax():
    """Curve.nlimbs (16-bit limbs, 2 W) and MSMConfig.windows against
    blaze_tpu's on every curve and at several window widths."""
    for name in sorted(CURVES):
        cv = Curve(CURVES[name])
        assert cv.nlimbs == RefCurve(REF_CURVES[name]).nlimbs == 2 * cv.nwords
    for c in (1, 4, 13, 16):
        for bits in (1, 8, 253, 255, 377):
            assert MSMConfig(window_bits=c).windows(bits) == \
                RefMSMConfig(window_bits=c).windows(bits)
