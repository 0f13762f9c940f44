"""K7's block schedule (blaze_tpu_torch/csrc/ntt.cuh) run on the host: the
header built with g++, where each PTX carry instruction is emulated, and
every thread of a block run pass by pass (the kernel's barrier intervals),
the threads first to last and last to first (a thread that read another
thread's output of the same pass, a race on the card, gives a different
result in one of the two).  Its outputs must equal ntt_base_plain (held
limb for limb against blaze_tpu's Pallas kernel in tests/test_torch_ntt.py)
on the four NTT fields (three 8-word, and the 12-word bls12_377_fq: three
16-byte planes per element), at K = 2, 8, 16, 64, 128, 256 and 512 (each
count of stages in the last pass, after none, one and two full passes),
at lane counts that leave the last block ragged, through three layouts:
(K, B) rows, a strided input read into a transposed output, and a
transposed buffer in place.
Skipped without g++.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blaze_tpu_torch.fields import FIELDS
from blaze_tpu_torch.ntt import NTTKernels
from blaze_tpu_torch.ntt.kernels import TileMap

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"

HOST_DRIVER = r"""
#define BLZ_DEVICE inline
#define BLZ_LDG(p) (*(p))
#include <cstdint>
#include <vector>
#include "ntt.cuh"

namespace nt = blz::ntt;

// One block: each pass (a barrier interval) run by every thread, in order
// or in reverse.
template <int W, int kLogK>
void run(const uint32_t* consts, const uint32_t* x, const uint32_t* pack, uint32_t* o,
         int64_t B, const int64_t* hin, const int64_t* hout, int rev) {
  using S = nt::Shape<W, kLogK>;
  const auto fc = blz::load_consts<W>(consts);
  const nt::TileMap in = nt::bit_fields(hin), out = nt::bit_fields(hout);
  std::vector<uint4> sm(S::kSmemBytes / 16, uint4{0xA5A5A5A5u, 1u, 2u, 3u});
  for (int64_t block = 0; block * S::NL < B; ++block) {
    for (int pass = 0; pass < S::kPasses; ++pass) {
      for (int i = 0; i < nt::kThreads; ++i) {
        const int tid = rev ? nt::kThreads - 1 - i : i;
        nt::run_pass<W, kLogK>(pass, tid, block, sm.data(), x, pack, o, B, in, out, fc);
      }
    }
  }
}

template <int W>
int run_w(int logK, const uint32_t* k, const uint32_t* x, const uint32_t* pack, uint32_t* o,
          int64_t B, const int64_t* in, const int64_t* out, int rev) {
  switch (logK) {
    case 1: run<W, 1>(k, x, pack, o, B, in, out, rev); return 0;
    case 3: run<W, 3>(k, x, pack, o, B, in, out, rev); return 0;
    case 4: run<W, 4>(k, x, pack, o, B, in, out, rev); return 0;
    case 6: run<W, 6>(k, x, pack, o, B, in, out, rev); return 0;
    case 7: run<W, 7>(k, x, pack, o, B, in, out, rev); return 0;
    case 8: run<W, 8>(k, x, pack, o, B, in, out, rev); return 0;
    case 9: run<W, 9>(k, x, pack, o, B, in, out, rev); return 0;
    default: return 1;
  }
}

extern "C" int ntt_host(int W, int logK, const uint32_t* k, const uint32_t* x,
                        const uint32_t* pack, uint32_t* o, int64_t B, const int64_t* in,
                        const int64_t* out, int rev) {
  if (W == 8) return run_w<8>(logK, k, x, pack, o, B, in, out, rev);
  if (W == 12) return run_w<12>(logK, k, x, pack, o, B, in, out, rev);
  return 1;
}

extern "C" int threads_per_lane(int logK) {
  switch (logK) {
    case 1: return nt::Shape<8, 1>::T;
    case 3: return nt::Shape<8, 3>::T;
    case 6: return nt::Shape<8, 6>::T;
    case 9: return nt::Shape<8, 9>::T;
    default: return 0;
  }
}
"""

# K -> lanes: the last block ragged (lanes per block 256, 256, 128, 32, 16,
# 8, 4); K = 16, 128 and 256 end on a pass of 1, 1 and 2 stages after full
# ones, the plans' [8, 8] (2^16) and [7, 7, 6] (2^20) among them
LANES = {2: 300, 8: 37, 16: 130, 64: 45, 128: 21, 256: 11, 512: 5}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build K7's schedule on the host")
    d = tmp_path_factory.mktemp("ntt_host")
    (d / "driver.cpp").write_text(HOST_DRIVER)
    so = d / "libntt.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(so), str(d / "driver.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.ntt_host.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, ctypes.c_int64, p, p,
                             ctypes.c_int]
    return lib


def canonical(spec, n: int, seed: int) -> torch.Tensor:
    """(n, W) int32 words of random values below 2^(bits-1) < p."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, spec.nwords),
                                             dtype=np.uint32)
    w[:, -1] &= (1 << (spec.bits - 1 - 32 * (spec.nwords - 1))) - 1
    return torch.from_numpy(w.view(np.int32))


def layouts(K: int, B: int):
    """(name, input rows, xmap, output rows, omap, in place)."""
    return [
        ("rows", K * B, TileMap.rows(B), K * B, TileMap.rows(B), False),
        ("strided_to_transposed", K * (B + 3), TileMap.lanes_at(B + 3), K * B,
         TileMap.lanes_at(1, K.bit_length() - 1), False),
        ("transposed_in_place", K * B, TileMap.lanes_at(1, K.bit_length() - 1), K * B,
         TileMap.lanes_at(1, K.bit_length() - 1), True),
    ]


def test_threads_per_lane(lib):
    """K/8 threads per lane from K = 8 on, one below."""
    assert [lib.threads_per_lane(k) for k in (1, 3, 6, 9)] == [1, 1, 8, 64]


@pytest.mark.parametrize("K", sorted(LANES))
@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr", "bls12_377_fq"])
def test_ntt_base_schedule_matches_plain(lib, field, K):
    spec = FIELDS[field]
    k = NTTKernels.for_spec(spec)
    B, logK = LANES[K], K.bit_length() - 1
    pack = canonical(spec, K, K + 1)
    for i, (name, nx, xmap, no, omap, in_place) in enumerate(layouts(K, B)):
        x = canonical(spec, nx, 10 * K + i)
        fresh = torch.zeros((no, spec.nwords), dtype=torch.int32)
        want = k.ntt_base_plain(x, pack, B, xmap, out=x.clone() if in_place else fresh,
                                omap=omap)
        for rev in (0, 1):
            src = x.clone()
            out = src if in_place else torch.zeros((no, spec.nwords), dtype=torch.int32)
            hx, ho = xmap.host(), omap.host()
            rc = lib.ntt_host(spec.nwords, logK, k._consts.ctypes.data, src.data_ptr(),
                              pack.data_ptr(), out.data_ptr(), B, hx.ctypes.data,
                              ho.ctypes.data, rev)
            assert rc == 0
            assert torch.equal(out, want), (name, rev)
