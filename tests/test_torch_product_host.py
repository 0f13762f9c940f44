"""K0's product (blaze_tpu_torch/csrc/carry.cuh) run on the host: the
header built with g++, where each PTX carry instruction is emulated and
the 64-bit C rows run as written, against Python integers and against the
lo / hi form it replaced (csrc/probe.cuh mont_rows, the E2 body mont_hi),
word for word, on the six fields: bn254_fq, bn254_fr, bls12_377_fr and bls12_381_fr
at W = 8, bls12_381_fq and bls12_377_fq at W = 12.

  * mont_mul_cc<W, false> (canonical, < p) and, where R > 4p,
    mont_mul_cc<W, true> (lazy, < 2p): exactly (T + m p) / R, m = T (-p^-1)
    mod R, T = a b, the lazy one with no final subtraction; on random
    operands and on operands near p (canonical) or near 2p (lazy);
  * mul_acc_cc: the unreduced 2W+1-word sum of t products, exactly, at
    t = 12 and 17 (the largest, t (p-1)^2, among them);
  * redc_sum after it: (T + m p) / R brought under p, canonical.

Skipped without g++.
"""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.fields.kernel_ops import field_consts, reduce_multiples

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"
FIELD_NAMES = ("bn254_fq", "bn254_fr", "bls12_377_fr", "bls12_381_fr", "bls12_381_fq",
               "bls12_377_fq")
LAZY_FIELDS = tuple(f for f in FIELD_NAMES if 4 * FIELDS[f].p < FIELDS[f].r)

HOST_SOURCE = r"""
#define BLZ_DEVICE inline
#include <cstdint>
#include "probe.cuh"

// op 0: r_i = mont_mul_cc(a_i, b_i); op 1: the lo / hi form (mont_rows,
// row 0); both lazy or canonical.  op 2: r = redc_sum of the sum of the n
// products a_i b_i (mul_acc_cc); op 3: that sum itself, 2W+1 words.
template <int W>
int run(const uint32_t* consts, int op, int lazy, const uint32_t* a, const uint32_t* b,
        uint32_t* r, int n, const uint32_t* mults, int nm) {
  const auto fc = blz::load_consts<W>(consts);
  namespace pb = blz::probe;
  if (op <= 1) {
    for (int i = 0; i < n; ++i) {
      const uint32_t *x = a + i * W, *y = b + i * W;
      uint32_t* z = r + i * W;
      if (op == 0 && lazy) blz::mont_mul_cc<W, true>(z, x, y, fc);
      else if (op == 0) blz::mont_mul_cc<W, false>(z, x, y, fc);
      else if (lazy) pb::mont_rows<W, 0, true>(z, x, y, fc);
      else pb::mont_rows<W, 0, false>(z, x, y, fc);
    }
    return 0;
  }
  uint32_t acc[2 * W + 1] = {};
  for (int i = 0; i < n; ++i) blz::mul_acc_cc<W>(acc, a + i * W, b + i * W);
  if (op == 2) {
    blz::redc_sum<W>(r, acc, fc, mults, nm);
  } else {
    for (int j = 0; j <= 2 * W; ++j) r[j] = acc[j];
  }
  return op <= 3 ? 0 : -1;
}

extern "C" int host_product(int W, const uint32_t* consts, int op, int lazy, const uint32_t* a,
                            const uint32_t* b, uint32_t* r, int n, const uint32_t* mults,
                            int nm) {
  return W == 8 ? run<8>(consts, op, lazy, a, b, r, n, mults, nm)
                : run<12>(consts, op, lazy, a, b, r, n, mults, nm);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build carry.cuh on the host")
    d = tmp_path_factory.mktemp("product_host")
    (d / "product_host.cpp").write_text(HOST_SOURCE)
    so = d / "libproduct.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(so), str(d / "product_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_product.argtypes = [i, p, i, i, p, p, p, i, p, i]
    lib.host_product.restype = i
    return lib


def words(ints, n):
    return np.stack([int_to_words(v, n) for v in ints]).astype(np.uint32)


def redc_value(spec, T: int) -> int:
    """(T + m p) / R with m = T (-p^-1) mod R, exactly."""
    m = T * spec.nprime % spec.r
    v, rem = divmod(T + m * spec.p, spec.r)
    assert rem == 0
    return v


def run(lib, spec, op, lazy, a, b, out_words, n, mults=None):
    consts = field_consts(spec)
    r = np.zeros((max(n, 1) if op <= 1 else 1, out_words), np.uint32)
    mptr = None if mults is None else mults.ctypes.data
    nm = 0 if mults is None else len(mults)
    rc = lib.host_product(spec.nwords, consts.ctypes.data, op, int(lazy), a.ctypes.data,
                          b.ctypes.data, r.ctypes.data, n, mptr, nm)
    assert rc == 0
    return [words_to_int(w) for w in r]


def operands(spec, lazy: bool, seed: int) -> list:
    """Edge values and random ones below p (canonical) or 2p (lazy)."""
    p = spec.p
    top = 2 * p if lazy else p
    rng = random.Random(seed)
    edge = [0, 1, 2, p - 2, p - 1, top - 2, top - 1] + ([p, p + 1] if lazy else [])
    return sorted(set(edge)) + [rng.randrange(top) for _ in range(12)]


@pytest.mark.parametrize("field,lazy", [(f, False) for f in FIELD_NAMES]
                         + [(f, True) for f in LAZY_FIELDS])
def test_product_is_the_exact_redc_and_equals_the_lo_hi_form(lib, field, lazy):
    spec = FIELDS[field]
    W = spec.nwords
    vals = operands(spec, lazy, seed=W + lazy)
    a_int = [u for u in vals for _ in vals]
    b_int = [v for _ in vals for v in vals]
    a, b = words(a_int, W), words(b_int, W)
    got = run(lib, spec, 0, lazy, a, b, W, len(a_int))
    want = []
    for u, v in zip(a_int, b_int):
        x = redc_value(spec, u * v)
        want.append(x if lazy or x < spec.p else x - spec.p)
    assert got == want
    assert max(got) < (2 if lazy else 1) * spec.p
    assert run(lib, spec, 1, lazy, a, b, W, len(a_int)) == got


def sum_cases(spec, t: int) -> list:
    p = spec.p
    rng = random.Random(t)
    return [[(p - 1, p - 1)] * t, [(0, p - 1)] * t, [(p - 1, 1)] * t,
            [(rng.randrange(p), rng.randrange(p)) for _ in range(t)]]


@pytest.mark.parametrize("t", [12, 17])
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_mul_acc_cc_sums_products_exactly(lib, field, t):
    spec = FIELDS[field]
    W = spec.nwords
    for pairs in sum_cases(spec, t):
        a, b = words([u for u, _ in pairs], W), words([v for _, v in pairs], W)
        assert run(lib, spec, 3, False, a, b, 2 * W + 1, t) == [sum(u * v for u, v in pairs)]


@pytest.mark.parametrize("t", [12, 17])
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_redc_sum_reduces_the_largest_sum_to_canonical(lib, field, t):
    spec = FIELDS[field]
    W = spec.nwords
    mults = words(reduce_multiples(spec, t), W + 1)
    for pairs in sum_cases(spec, t):
        T = sum(u * v for u, v in pairs)
        a, b = words([u for u, _ in pairs], W), words([v for _, v in pairs], W)
        got = run(lib, spec, 2, False, a, b, W, t, mults)
        assert got == [redc_value(spec, T) % spec.p]
        assert got == [T * pow(spec.r, -1, spec.p) % spec.p]
