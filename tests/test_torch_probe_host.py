"""The probe bodies' device code (blaze_tpu_torch/csrc/probe.cuh on carry.cuh)
run on the host: the header built with g++, where each PTX instruction is
emulated, and every body chained M times over each element, against its
plain version (experiments/chain.py probe_chain_plain, held against
blaze_tpu and Python ints in tests/test_torch_experiments.py) at W = 8 and
12, on canonical values, values near p and, for the bodies that take any
words, near R.  Skipped without g++.
"""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blaze_tpu_torch.experiments.chain import BODIES, probe_chain_plain
from blaze_tpu_torch.fields import FIELDS, int_to_words
from blaze_tpu_torch.fields.kernel_ops import field_consts

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"
FIELD_NAMES = ("bls12_381_fr", "bls12_381_fq")      # W = 8 and 12
ANY_WORDS = ("conv", "carry", "mul_lo", "mul_hi", "mul_wide", "conv_f32")

HOST_SOURCE = r"""
#define BLZ_DEVICE inline
#include <cstdint>
#include "probe.cuh"

template <int W, int kBody>
void run(const uint32_t* consts, uint32_t* x, const uint32_t* b, int n, int M) {
  const auto fc = blz::load_consts<W>(consts);
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < M; ++k) blz::probe::step<W, kBody>(x + i * W, b + i * W, fc);
}

template <int W>
int run_w(int body, const uint32_t* consts, uint32_t* x, const uint32_t* b, int n, int M) {
  namespace pb = blz::probe;
  switch (body) {
#define BLZ_CASE(k) case pb::k: run<W, pb::k>(consts, x, b, n, M); return 0;
    BLZ_CASE(kMont) BLZ_CASE(kConv) BLZ_CASE(kCarry) BLZ_CASE(kRedc) BLZ_CASE(kAddF)
    BLZ_CASE(kSubF) BLZ_CASE(kMulLo) BLZ_CASE(kMulHi) BLZ_CASE(kMulWide)
    BLZ_CASE(kConvF32) BLZ_CASE(kMont11) BLZ_CASE(kGlue15) BLZ_CASE(kMontHi)
    BLZ_CASE(kMontRz) BLZ_CASE(kMontComba) BLZ_CASE(kMontSplit)
    BLZ_CASE(kMontWide) BLZ_CASE(kMontPair64)
#undef BLZ_CASE
    default: return -1;
  }
}

extern "C" int host_chain(int W, int body, const uint32_t* consts, uint32_t* x,
                          const uint32_t* b, int n, int M) {
  return W == 8 ? run_w<8>(body, consts, x, b, n, M) : run_w<12>(body, consts, x, b, n, M);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build probe.cuh on the host")
    d = tmp_path_factory.mktemp("probe_host")
    (d / "probe_host.cpp").write_text(HOST_SOURCE)
    so = d / "libprobe.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(so), str(d / "probe_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.host_chain.argtypes = [i, i, p, p, p, i, i]
    return lib


def operands(spec, body, n, seed):
    """(n, W) words: canonical values, p - 1 - k first; for the bodies that
    take any words, R - 1 - k in the last rows too."""
    rng = random.Random(seed)
    W = spec.nwords
    vals = [rng.randrange(spec.p) for _ in range(n)]
    vals[:3] = [spec.p - 1 - k for k in range(3)]
    if body in ANY_WORDS:
        vals[-3:] = [spec.r - 1 - k for k in range(3)]
    return np.stack([int_to_words(v, W) for v in vals])


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("body", BODIES)
def test_body_on_the_host_equals_its_plain_version(lib, field, body):
    spec = FIELDS[field]
    W, n, M = spec.nwords, 24, 3
    x = operands(spec, body, n, 1)
    b = operands(spec, body, n, 2)
    want = probe_chain_plain(spec, body, torch.as_tensor(x.view(np.int32)),
                             torch.as_tensor(b.view(np.int32)), M)
    got = np.ascontiguousarray(x)
    rc = lib.host_chain(W, BODIES.index(body), field_consts(spec).ctypes.data,
                        got.ctypes.data, b.ctypes.data, n, M)
    assert rc == 0
    np.testing.assert_array_equal(got.view(np.int32), want.numpy())
