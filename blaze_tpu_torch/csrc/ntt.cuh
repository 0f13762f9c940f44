// K7's block schedule: whole K-point NTTs (K <= 512), one per lane, on
// element-contiguous data, for Hopper (sm_90a).
//
// Layout.  An element is W consecutive 32-bit words: 32 bytes, one sector
// of device memory, at W = 8; 48 bytes at W = 12.  Point k of lane l lies
// at element
//   k * ks + sum_t ((l >> src_t) % 2^wid_t) << dst_t      (TileMap)
// of its buffer, so a batch may be read through the strides of a
// Cooley-Tukey level (fused.py) instead of a transposed copy, and every
// load or store moves whole sectors whatever the strides.  Input in
// natural order (point rev(k) is loaded into position k), output in
// natural order, every value canonical.
//
// Schedule.  A block holds NL lanes of K points in a shared-memory tile;
// each thread owns P = 8 positions of one lane per pass (K >= 8; K/8
// threads per lane, 256 threads per block, NL = 2048 / K) and runs up to
// three radix-2 DIT stages on them before the next barrier: the log2 K
// stages are passes of 3 (the last of 1-3), and the threads meet only
// between passes (2 barriers at K = 512, against 10 in the one-butterfly-
// per-thread design).  Pass 0 fills its positions straight from device
// memory (bit-reversed rows) and the last pass writes them straight back;
// the warps hold 32 / NL groups of NL lanes, so a warp's loads and stores
// are runs of NL lanes (4 at K = 512: 128 B) or of consecutive points of
// one lane.  Positions of pass p's groups: stages s0 = 3p .. s0 + r - 1
// pair positions that differ in bits s0 .. s0 + r - 1; thread g takes
// groups q = g + (K/8) u, u < 8 / 2^r.
//
// Code size.  A butterfly's product, add and sub are about 650
// instructions.  Each butterfly loads its two points from the tile and
// stores them back, so one copy of a stage's four butterflies serves every
// stage and pass (the stage and pass loops are not unrolled).  Keeping the
// eight points in registers across a pass needed every butterfly of the
// kernel unrolled, 22,688 SASS instructions at K = 512 (363 KB of code),
// and ran 36-39 ms per level of the 2^27 plan on an H100, against 17.9 ms
// for this one (before it skipped the W^0 products); one butterfly's code
// in a loop ran 18.6 ms (PERF.md).
//
// Shared memory: the tile as W/4 planes of 16-byte words (plane h holds
// words 4h .. 4h+3 of each element), element e = pos * NL + lane at
// e + 4 (e / 32): with that padding the 8 threads of each quarter-warp
// touch 8 different 16-byte bank groups in every stage.  At K = 512, 72 KB
// per block at W = 8, three blocks per SM (24 warps; 76 registers a
// thread), and 108 KB at W = 12, two blocks per SM (16 warps; 122
// registers a thread, no spills).  The twiddle pack (K entries, 16 or 24
// KB at K = 512) stays in device memory and is read through the read-only
// path; it is the same for every block, so it stays in L1.
//
// Products are K0's canonical product (carry.cuh mont_mul_cc), adds and
// subs carry.cuh's canonical carry-chain ones.
//
// Without __CUDA_ARCH__ (g++, BLZ_DEVICE defined as inline) the carry
// instructions are emulated and each pass is a function of one thread,
// so a host driver can run a block's threads pass by pass in any order
// (tests/test_torch_ntt_host.py).
#pragma once

#include "carry.cuh"

#ifndef BLZ_LDG
#define BLZ_LDG(p) __ldg(p)
#endif

namespace blz {
namespace ntt {

constexpr int kMaxLogK = 9;
constexpr int kThreads = 256;      // threads per block
constexpr int kMaxFields = 6;      // bit fields of a BitFields

// A head and up to kMaxFields bit fields (src, wid, dst) of an index x,
// which give sum_t ((x >> src[t]) % 2^wid[t]) << dst[t]; unused fields are
// (0, 0, 0).  Every digit of a plan's storage order is a power of two, so
// K7's TileMap (head: the point stride ks, x: the lane) and K9's row map
// (head: the shift of the twiddle row v, x: the element's position) are
// both this form, and one host encoder (ntt/kernels.py bit_fields_host)
// writes it: head, then (src, wid, dst) per field, as int64.
struct BitFields {
  int64_t head;
  int src[kMaxFields];
  int wid[kMaxFields];
  int dst[kMaxFields];
};
using TileMap = BitFields;

inline BitFields bit_fields(const int64_t* h) {
  BitFields f;
  f.head = h[0];
  for (int t = 0; t < kMaxFields; ++t) {
    f.src[t] = (int)h[1 + 3 * t];
    f.wid[t] = (int)h[2 + 3 * t];
    f.dst[t] = (int)h[3 + 3 * t];
  }
  return f;
}

BLZ_DEVICE int64_t field_sum(const BitFields& f, uint64_t x) {
  int64_t s = 0;
#pragma unroll
  for (int t = 0; t < kMaxFields; ++t)
    s += (int64_t)((x >> f.src[t]) & ((1ull << f.wid[t]) - 1)) << f.dst[t];
  return s;
}

template <int W, int kLogK>
struct Shape {
  static constexpr int K = 1 << kLogK;
  static constexpr int P = K < 8 ? K : 8;            // points per thread and pass
  static constexpr int T = K / P;                    // threads per lane
  static constexpr int NL = kThreads / T;            // lanes per block
  static constexpr int kPasses = (kLogK + 2) / 3;
  static constexpr int kQ = W / 4;                   // 16-byte words per element
  static constexpr int kTile = NL * K;
  static constexpr int kPlane = kTile + (kTile / 32) * 4;
  static constexpr int kSmemBytes = 16 * kQ * kPlane;
};

template <int kBits>
BLZ_DEVICE int bitrev(int x) {
#ifdef __CUDA_ARCH__
  return (int)(__brev((unsigned)x) >> (32 - kBits));
#else
  int r = 0;
  for (int b = 0; b < kBits; ++b) r |= ((x >> b) & 1) << (kBits - 1 - b);
  return r;
#endif
}

BLZ_DEVICE int padded(int e) { return e + ((e >> 5) << 2); }

template <int W>
BLZ_DEVICE void load_el(uint32_t* v, const uint32_t* p) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// The same through the read-only path (a table no kernel writes).
template <int W>
BLZ_DEVICE void ldg_el(uint32_t* v, const uint32_t* p) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 a = BLZ_LDG(reinterpret_cast<const uint4*>(p) + q);
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

template <int W>
BLZ_DEVICE void store_el(uint32_t* p, const uint32_t* v) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    reinterpret_cast<uint4*>(p)[q] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
}

// Element e of the tile, its planes `plane` 16-byte words apart.
template <int W>
BLZ_DEVICE void sm_load(uint32_t* v, const uint4* sm, int plane, int e) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 a = sm[q * plane + e];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

template <int W>
BLZ_DEVICE void sm_store(uint4* sm, int plane, int e, const uint32_t* v) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    sm[q * plane + e] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
}

// Thread `tid` of block `block` runs pass `pass`: the radix-2 DIT stages
// 3 pass .. 3 pass + r - 1 (r <= 3) on the P positions it owns in this
// pass, u = 0 .. P/2^r - 1 groups q = g + T u of 2^r positions
//   (q % 2^s0) + ((q >> s0) << (s0 + r)) + (j << s0),  s0 = 3 pass,
// each butterfly loading its two points from the tile and storing them
// back, the twiddle from device memory (L1-resident: K entries).  Pass 0
// first fills its positions from x through `in` (position k <- row
// rev(k)); the last pass then writes its positions to o through `out`.
// The caller puts a barrier between passes.  pack: K twiddles, entry
// m - 1 + t (m = 2^s) that of stage s at butterfly position t.  A
// butterfly at t = 0 (all of stage 0, K/2^(s+1) of stage s) has twiddle
// W^0 = 1 and skips the product; entry m - 1 is never read.  These are
// K/2 - 1 of the (K/2)(log2 K - 1) products past stage 0.  In pass 0 t is
// the same for all of a warp's threads (3 of a thread's 32 products at K =
// 512 skipped); in later passes it differs between them, and the warp runs
// the product for the threads that need it.
template <int W, int kLogK>
BLZ_DEVICE void run_pass(int pass, int tid, int64_t block, uint4* sm, const uint32_t* x,
                         const uint32_t* pack, uint32_t* o, int64_t B, const TileMap& in,
                         const TileMap& out, const FieldConsts<W>& fc) {
  using S = Shape<W, kLogK>;
  const int s0 = 3 * pass;
  const int r = kLogK - s0 < 3 ? kLogK - s0 : 3;
  const int t = tid % S::NL;
  const int g = tid / S::NL;
  const int64_t lane = block * S::NL + t;
  const bool live = lane < B;
  // position of the thread's point i = u 2^r + j in this pass
  auto pos = [&](int i) {
    const int q = g + S::T * (i >> r);
    return (q & ((1 << s0) - 1)) + ((q >> s0) << (s0 + r)) + ((i & ((1 << r) - 1)) << s0);
  };
  auto at = [&](int p) { return padded(p * S::NL + t); };
  uint32_t u[W], v[W], w[W];

  if (pass == 0) {
    const int64_t lo = live ? field_sum(in, (uint64_t)lane) : 0;
#pragma unroll 1
    for (int i = 0; i < S::P; ++i) {
      const int p = pos(i);
      if (live) {
        load_el<W>(v, x + (bitrev<kLogK>(p) * in.head + lo) * W);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) v[k] = 0;
      }
      sm_store<W>(sm, S::kPlane, at(p), v);
    }
  }

#pragma unroll 1
  for (int st = 0; st < r; ++st) {
    const int s = s0 + st;
#pragma unroll
    for (int bf = 0; bf < S::P / 2; ++bf) {
      // butterfly bf of this stage: group u, pair (j, j + 2^st), bit st of j clear
      const int k = bf & ((1 << (r - 1)) - 1);      // 2^(r-1) butterflies per group
      const int j = (k & ((1 << st) - 1)) + ((k >> st) << (st + 1));
      const int i = ((bf >> (r - 1)) << r) + j;
      const int pa = pos(i), pb = pa + (1 << s);
      sm_load<W>(u, sm, S::kPlane, at(pa));
      sm_load<W>(v, sm, S::kPlane, at(pb));
      const int tw = pa & ((1 << s) - 1);           // twiddle W^tw of the stage
      if (tw) {
        ldg_el<W>(w, pack + ((1 << s) - 1 + tw) * W);
        mont_mul_cc<W, false>(v, v, w, fc);
      }
      add_canon<W>(w, u, v, fc);
      sub_canon<W>(v, u, v, fc);
      sm_store<W>(sm, S::kPlane, at(pa), w);
      sm_store<W>(sm, S::kPlane, at(pb), v);
    }
  }

  if (pass == S::kPasses - 1 && live) {
    const int64_t lo = field_sum(out, (uint64_t)lane);
#pragma unroll 1
    for (int i = 0; i < S::P; ++i) {
      const int p = pos(i);
      sm_load<W>(v, sm, S::kPlane, at(p));
      store_el<W>(o + (p * out.head + lo) * W, v);
    }
  }
}

}  // namespace ntt
}  // namespace blz
