"""K10's device code (blaze_tpu_torch/csrc/poseidon.cuh on carry.cuh) run on
the host: the headers built with g++, where each PTX carry instruction is
emulated, and the permutation run state by state over a column of stride 1,
at W = 8 and 12, with both schedules (sparse partial rounds, and the dense rounds of an instance
whose MDS has a singular lower-right block).  Its words must equal the dense plain version
(`PoseidonKernels.permute_lm_plain`, held against blaze_tpu in
tests/test_torch_poseidon.py), on the three scalar fields (and the 12-word
base fields, and t = 17), with and without
convert_in, on states near p; the canonical carry-chain product and the
unreduced sum with its REDC must equal Python ints at the edges.  Skipped
without g++.
"""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.fields.kernel_ops import reduce_multiples
from blaze_tpu_torch.hash import PoseidonKernels, generate_params, params_from_reference

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"
SCALAR_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")

HOST_DRIVER = r"""
#define BLZ_DEVICE inline
#define BLZ_LDG(p) (*(p))
#include <cstdint>
#include <vector>
#include "poseidon.cuh"

// States (t, W, B) lanes-major; each one copied into a column of stride 1,
// permuted (a second column for the dense mixes beside it), copied out.
template <int W>
int perm(const uint32_t* consts, const uint32_t* pc, int t, int r_f, int r_p, int nm,
         int sparse, const uint32_t* x, uint32_t* o, int64_t B, int convert_in) {
  const auto fc = blz::load_consts<W>(consts);
  const blz::PoseidonShape sh{t, r_f, r_p, nm, sparse};
  const int words = t * W;
  std::vector<uint32_t> col(2 * words);
  for (int64_t b = 0; b < B; ++b) {
    for (int i = 0; i < words; ++i) col[i] = x[i * B + b];
    const uint32_t* res =
        blz::poseidon_permute<W>(col.data(), col.data() + words, 1, convert_in, pc, sh, fc);
    for (int i = 0; i < words; ++i) o[i * B + b] = res[i];
  }
  return 0;
}

extern "C" int host_perm(int W, const uint32_t* consts, const uint32_t* pc, int t, int r_f,
                         int r_p, int nm, int sparse, const uint32_t* x, uint32_t* o, int64_t B,
                         int convert_in) {
  return W == 8 ? perm<8>(consts, pc, t, r_f, r_p, nm, sparse, x, o, B, convert_in)
                : perm<12>(consts, pc, t, r_f, r_p, nm, sparse, x, o, B, convert_in);
}

// op 0: r_i = a_i b_i / R (canonical carry-chain product), n pairs;
// op 1: r = (sum_i a_i b_i) / R mod p (mul_acc_cc + redc_sum), n pairs.
template <int W>
void field(const uint32_t* consts, int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
           int n, const uint32_t* mults, int nm) {
  const auto fc = blz::load_consts<W>(consts);
  if (op == 0) {
    for (int i = 0; i < n; ++i) blz::mont_mul_cc<W, false>(r + i * W, a + i * W, b + i * W, fc);
    return;
  }
  uint32_t acc[2 * W + 1] = {};
  for (int i = 0; i < n; ++i) blz::mul_acc_cc<W>(acc, a + i * W, b + i * W);
  blz::redc_sum<W>(r, acc, fc, mults, nm);
}

extern "C" void host_field(int W, const uint32_t* consts, int op, const uint32_t* a,
                           const uint32_t* b, uint32_t* r, int n, const uint32_t* mults,
                           int nm) {
  if (W == 8) field<8>(consts, op, a, b, r, n, mults, nm);
  else field<12>(consts, op, a, b, r, n, mults, nm);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build poseidon.cuh on the host")
    d = tmp_path_factory.mktemp("poseidon_host")
    (d / "driver.cpp").write_text(HOST_DRIVER)
    so = d / "libposeidon.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(so), str(d / "driver.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_perm.argtypes = [i, p, p, i, i, i, i, i, p, p, ctypes.c_int64, i]
    lib.host_field.argtypes = [i, p, i, p, p, p, i, p, i]
    return lib


def ptr(x) -> int:
    return x.ctypes.data if isinstance(x, np.ndarray) else x.data_ptr()


def singular_block(params):
    """`params` with row 2 of the MDS copied from row 1 past column 0: the
    lower-right block is singular, so K10 keeps the dense rounds."""
    mds = [list(row) for row in params.mds]
    mds[2][1:] = mds[1][1:]
    return params_from_reference(params.spec, params.t, params.alpha, params.r_f, params.r_p,
                                 params.round_constants, mds)


def near_p_states(spec, t, B, seed):
    """(t, W, B) canonical words: p - 1 - k in every element of the first
    states (k < 3), random elements after them."""
    rng = random.Random(seed)
    vals = [[spec.p - 1 - b] * t if b < 3 else [rng.randrange(spec.p) for _ in range(t)]
            for b in range(B)]
    w = np.stack([np.stack([int_to_words(v, spec.nwords) for v in s]) for s in vals])
    return torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0)).view(np.int32))


def host_permute(lib, k: PoseidonKernels, x, convert_in: bool):
    p = k.params
    o = torch.empty_like(x)
    rc = lib.host_perm(k.W, ptr(k._consts), ptr(k._block), p.t, p.r_f, p.r_p, k._nm, int(k.sparse),
                       ptr(x), ptr(o), x.shape[2], int(convert_in))
    assert rc == 0
    return o


@pytest.mark.parametrize("t", [9, 12])
@pytest.mark.parametrize("field", SCALAR_FIELDS)
def test_host_permutation_matches_plain(lib, field, t):
    spec = FIELDS[field]
    k = PoseidonKernels.for_params(generate_params(spec, t))
    assert k.sparse
    x = near_p_states(spec, t, 4, seed=t)
    for conv in (False, True):
        assert torch.equal(host_permute(lib, k, x, conv), k.permute_lm_plain(x, conv)), conv


@pytest.mark.parametrize("t", [9, 12])
def test_host_dense_rounds_match_plain(lib, t):
    """The singular-block instance: the dense schedule."""
    spec = FIELDS["bls12_381_fr"]
    k = PoseidonKernels.for_params(singular_block(generate_params(spec, t)))
    assert not k.sparse
    x = near_p_states(spec, t, 4, seed=30 + t)
    for conv in (False, True):
        assert torch.equal(host_permute(lib, k, x, conv), k.permute_lm_plain(x, conv)), conv


def test_host_other_width_matches_plain(lib):
    """t = 3, the smallest width the tree's parameters generate."""
    spec = FIELDS["bn254_fr"]
    k = PoseidonKernels.for_params(generate_params(spec, 3))
    x = near_p_states(spec, 3, 5, seed=3)
    assert torch.equal(host_permute(lib, k, x, True), k.permute_lm_plain(x, True))


@pytest.mark.parametrize("field,t", [("bls12_381_fq", 3), ("bls12_377_fq", 5),
                                     ("bn254_fr", 17), ("bls12_381_fq", 17)])
def test_host_12_word_fields_and_t17_match_plain(lib, field, t):
    """The 12-word base fields (R / p is 9.8 and 152, against 2.2 to 13.7
    for the scalar fields, so the REDC subtracts other multiples) and
    t = 17, the widest state of the reference's round table."""
    spec = FIELDS[field]
    k = PoseidonKernels.for_params(generate_params(spec, t))
    assert k.sparse and k.W == spec.nwords
    x = near_p_states(spec, t, 4, seed=50 + t)
    for conv in (False, True):
        assert torch.equal(host_permute(lib, k, x, conv), k.permute_lm_plain(x, conv)), conv


@pytest.mark.parametrize("field", SCALAR_FIELDS + ("bls12_381_fq", "bls12_377_fq"))
def test_host_carry_chain_field_ops(lib, field):
    """mont_mul_cc<canonical> on every pair of edge and random values, and
    mul_acc_cc + redc_sum on t = 12 pairs, the largest sum t (p-1)^2
    included, against Python ints."""
    spec = FIELDS[field]
    k = PoseidonKernels.for_params(generate_params(spec, 12))
    p, W = spec.p, spec.nwords
    rinv = pow(spec.r, -1, p)
    rng = random.Random(9)
    vals = [0, 1, 2, p - 2, p - 1] + [rng.randrange(p) for _ in range(11)]
    a_int = [u for u in vals for _ in vals]
    b_int = [v for _ in vals for v in vals]

    def words(ints):
        return np.stack([int_to_words(v, W) for v in ints])

    a, b, r = words(a_int), words(b_int), np.empty((len(a_int), W), np.uint32)
    lib.host_field(W, ptr(k._consts), 0, ptr(a), ptr(b), ptr(r), len(a_int), None, 0)
    assert [words_to_int(w) for w in r] == [u * v * rinv % p for u, v in zip(a_int, b_int)]
    mults = np.concatenate([int_to_words(m, W + 1) for m in reduce_multiples(spec, 12)])
    for pairs in ([(p - 1, p - 1)] * 12, [(0, p - 1)] * 12,
                  [(rng.randrange(p), rng.randrange(p)) for _ in range(12)]):
        a, b = words([u for u, _ in pairs]), words([v for _, v in pairs])
        out = np.empty(W, np.uint32)
        lib.host_field(W, ptr(k._consts), 1, ptr(a), ptr(b), ptr(out), 12, ptr(mults),
                       len(mults) // (W + 1))
        assert words_to_int(out) == sum(u * v for u, v in pairs) * rinv % p
