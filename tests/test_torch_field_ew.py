"""KF, the Field's elementwise kernel (blaze_tpu_torch/fields/elementwise.py,
csrc/field_ew.cu), on the CPU.

Its plain version (the int64 Kogge-Stone path that Field.add / sub / neg /
double / _cond_sub_p run on CPU tensors) against blaze_tpu's Field on the
same numpy-seeded values, on every field of both widths, with the edge
values 0, 1 and p - 1, and lazy values up to 2p - 1 (with and without a
carry word) for canon.  Then the kernel's element function
(csrc/field_ew.cuh) built with g++ on the host, where each PTX carry
instruction is emulated, against the plain version on canonical values
and on any 32-bit words (skipped without g++).  Last, the wrapper's
refusals.  Every comparison is exact.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu_torch.fields import FIELDS, Field
from blaze_tpu_torch.fields.elementwise import OPS, field_ew, field_ew_plain
from blaze_tpu_torch.fields.kernel_ops import field_consts

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"
M = 64


def rand_ints(n: int, bound: int, seed: int) -> list[int]:
    """n integers uniform in [0, bound), from seeded numpy words."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, (bound.bit_length() + 95) // 32), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % bound for row in words]


def operands(p: int, seed: int, bound: int | None = None) -> list[int]:
    """M values below `bound` (p by default) led by the edges 0, 1, p - 1
    (and p, bound - 1 for a lazy bound)."""
    bound = bound or p
    edges = [0, 1, p - 1] + ([p, bound - 1] if bound > p else [])
    return edges + rand_ints(M - len(edges), bound, seed)


def to_words(vals, spec) -> torch.Tensor:
    raw = b"".join(v.to_bytes(4 * spec.nwords, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, dtype="<u4").view(np.int32)
                            .reshape(len(vals), spec.nwords).copy())


def words_ints(t: torch.Tensor) -> list[int]:
    return [int.from_bytes(r.tobytes(), "little")
            for r in t.numpy().view(np.uint32).reshape(t.shape[0], -1)]


def limbs_ints(a) -> list[int]:
    return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in np.asarray(a)]


def to_limbs(vals, spec):
    raw = b"".join(v.to_bytes(4 * spec.nwords, "little") for v in vals)
    return jnp.asarray(np.frombuffer(raw, dtype="<u2").astype(np.uint32)
                       .reshape(len(vals), 2 * spec.nwords))


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_matches_reference_field(name):
    """field_ew_plain, through the port's Field, against blaze_tpu's Field
    on canonical operands (canon on lazy values < 2p, without and with a
    carry word) and Python ints."""
    spec = FIELDS[name]
    p = spec.p
    f, rf = Field(spec), RefField(REF_FIELDS[name])
    a_i, b_i = operands(p, seed=1), operands(p, seed=2)[::-1]
    a, b = to_words(a_i, spec), to_words(b_i, spec)
    ra, rb = to_limbs(a_i, spec), to_limbs(b_i, spec)
    lazy_i = operands(p, seed=3, bound=2 * p)
    lazy = to_words(lazy_i, spec)
    # a carry word above the element: x - p mod 2^(32W) whatever x is
    R = 1 << (32 * spec.nwords)
    top = torch.from_numpy(np.random.default_rng(4).integers(0, 2, size=M))
    top_ints = [(x - p) % R if t or x >= p else x for x, t in zip(lazy_i, top.tolist())]
    cases = {
        "add": (f.add(a, b), rf.add(ra, rb), [(x + y) % p for x, y in zip(a_i, b_i)]),
        "sub": (f.sub(a, b), rf.sub(ra, rb), [(x - y) % p for x, y in zip(a_i, b_i)]),
        "neg": (f.neg(a), rf.neg(ra), [(-x) % p for x in a_i]),
        "double": (f.double(a), rf.double(ra), [2 * x % p for x in a_i]),
        "canon": (f._cond_sub_p(lazy), rf._cond_sub_p(to_limbs(lazy_i, spec),
                                                      jnp.zeros(M, jnp.uint32)),
                  [x % p for x in lazy_i]),
        "canon_top": (f._cond_sub_p(lazy, top),
                      rf._cond_sub_p(to_limbs(lazy_i, spec),
                                     jnp.asarray(top.numpy(), jnp.uint32)), top_ints),
    }
    for op, (got, ref, ints) in cases.items():
        assert words_ints(got) == ints, (name, op)
        assert words_ints(got) == limbs_ints(ref), (name, op)


def test_plain_broadcasts_as_the_field_did():
    """(B, 1, W) against (1, K, W) and a (K,) carry word: the shapes the
    Curve's callers pass."""
    spec = FIELDS["bls12_381_fq"]
    a = to_words(operands(spec.p, seed=4)[:3], spec).reshape(3, 1, -1)
    b = to_words(operands(spec.p, seed=5)[:4], spec).reshape(1, 4, -1)
    for op in ("add", "sub"):
        got = field_ew(spec, op, a, b)
        want = field_ew(spec, op, a.expand(3, 4, -1).contiguous(), b.expand(3, 4, -1))
        assert got.shape == (3, 4, spec.nwords) and torch.equal(got, want)
    top = torch.tensor([0, 1, 0, 1])
    got = field_ew(spec, "canon", b.reshape(4, -1), top)
    assert torch.equal(got, field_ew(spec, "canon", b.reshape(4, -1),
                                     top.to(torch.int32)))


HOST_SOURCE = r"""
#define BLZ_DEVICE inline
#include <cstdint>
#include "field_ew.cuh"

template <int W>
void run(const uint32_t* consts, int op, const uint32_t* a, const uint32_t* b,
         const int32_t* top, uint32_t* o, int64_t n) {
  const auto fc = blz::load_consts<W>(consts);
  for (int64_t i = 0; i < n; ++i)
    blz::field_ew_element<W>(op, o + i * W, a + i * W, b + i * W,
                             top ? (uint32_t)top[i] : 0u, fc);
}

extern "C" void host_field_ew(int W, const uint32_t* k, int op, const uint32_t* a,
                              const uint32_t* b, const int32_t* top, uint32_t* o,
                              int64_t n) {
  if (W == 8) run<8>(k, op, a, b, top, o, n);
  else run<12>(k, op, a, b, top, o, n);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build KF's element function on the host")
    d = tmp_path_factory.mktemp("field_ew")
    (d / "field_ew_host.cpp").write_text(HOST_SOURCE)
    so = d / "libfield_ew.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(so), str(d / "field_ew_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.host_field_ew.argtypes = [ctypes.c_int, p, ctypes.c_int, p, p, p, p, ctypes.c_int64]
    return lib


def host_field_ew(lib, spec, op: str, a, b, top=None) -> torch.Tensor:
    out = torch.empty_like(a)
    lib.host_field_ew(spec.nwords, field_consts(spec).ctypes.data, OPS.index(op),
                      a.data_ptr(), b.data_ptr(), None if top is None else top.data_ptr(),
                      out.data_ptr(), a.shape[0])
    return out


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_host_build_matches_plain(lib, name):
    """KF's element function (g++, emulated carries) against the plain
    version: every op on canonical values with the edges, canon on lazy
    values with and without a carry word, and every op on any 32-bit
    words (the two agree beyond the Field's invariant too)."""
    spec = FIELDS[name]
    p = spec.p
    a, b = to_words(operands(p, seed=6), spec), to_words(operands(p, seed=7)[::-1], spec)
    lazy = to_words(operands(p, seed=8, bound=2 * p), spec)
    any_a = torch.from_numpy(np.random.default_rng(9).integers(
        -2**31, 2**31, size=(M, spec.nwords), dtype=np.int32))
    any_b = torch.from_numpy(np.random.default_rng(10).integers(
        -2**31, 2**31, size=(M, spec.nwords), dtype=np.int32))
    any_a[:4] = -1                                         # all ones
    top = torch.from_numpy(np.random.default_rng(11).integers(0, 2, size=M, dtype=np.int32))
    for x, y in ((a, b), (b, a), (a, a), (any_a, any_b)):
        for op in OPS:
            got = host_field_ew(lib, spec, op, x, y)
            want = field_ew_plain(spec, op, x, None if op == "canon" else y)
            assert torch.equal(got, want), (name, op)
    for x in (lazy, any_a):
        for t in (None, top):
            got = host_field_ew(lib, spec, "canon", x, x, t)
            assert torch.equal(got, field_ew_plain(spec, "canon", x, t)), (name, t)


@pytest.mark.parametrize("case", [
    "op", "dtype", "width", "b_missing", "b_dtype", "b_width", "no_broadcast",
    "top_no_broadcast", "top_float", "field_width",
])
def test_wrapper_refuses(case):
    """A wrong op, dtype or W, a missing or mismatched b, shapes that do not
    broadcast, a float carry word, and a field KF is not built for."""
    from blaze_tpu_torch.fields import FieldSpec

    spec = FIELDS["bn254_fq"]
    a = to_words(operands(spec.p, seed=12)[:4], spec)
    args = {
        "op": (spec, "mul", a, a),
        "dtype": (spec, "add", a.to(torch.int64), a),
        "width": (spec, "neg", a[:, :7].contiguous()),
        "b_missing": (spec, "sub", a),
        "b_dtype": (spec, "add", a, a.to(torch.int64)),
        "b_width": (spec, "add", a, a[:, :4]),
        "no_broadcast": (spec, "add", a, a[:3]),
        "top_no_broadcast": (spec, "canon", a, torch.zeros(3, dtype=torch.int64)),
        "top_float": (spec, "canon", a, torch.zeros(4)),
        "field_width": (FieldSpec("m61", (1 << 61) - 1), "add",
                        torch.zeros((4, 2), dtype=torch.int32),
                        torch.zeros((4, 2), dtype=torch.int32)),
    }[case]
    with pytest.raises(ValueError):
        field_ew(*args)
