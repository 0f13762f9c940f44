// K2-K6: the MSM's EC kernels, lanes-major (rows of words x lanes).
//
// A batch of projective points is (3W, B) words: X words in rows 0..W-1,
// Y in W..2W-1, Z in 2W..3W-1, lane b at column b — neighbouring threads
// touch neighbouring words, so every load and store of a warp is one
// coalesced 128-byte line.  All values stay in the lazy < 2p range.
//
// Replaces (blaze_tpu/curves/kernels.py, ECKernels):
//   K2 blz_scan_mixed  <- _scan_fn / scan_mixed   (per-lane prefix of mixed adds;
//      blz_scan_gathered, the same kernel reading its points through a sort)
//   K3 blz_ec_add      <- _add_fn / add           (batched complete add)
//   K4 blz_reduce_cols <- _reduce_fn / reduce_cols (lane-wise sum over rows)
//   K5 blz_dbl_n       <- _dbl_fn / dbl_n         (k doublings per lane)
//   K6 blz_fold_horner <- _fold_fn / fold_horner  (Horner window fold)
//
// Bound on the H100: integer multiply-adds (13 or 14 Montgomery products
// per group op, each 2 * (2W^2 + W) IMADs).  On the TPU the sequential axis
// was a grid axis with the running sum in VMEM scratch; here it is a loop
// with the running sum on the SM, and the lanes are the parallel axis.
//
// Every kernel here runs a team of kTeam = 6 threads per lane
// (ec_team.cuh).
//
// K2 and K4: with one thread per lane they were latency-bound: the MSM
// gives them few lanes (K2 16384 at a 2^19 chunk, 8192 at a streamed 2^18
// chunk; K4's first pass 8192), about one warp per scheduler, and each
// thread's chain of 13-14 dependent products was the critical path (23.6
// and 14.1 ms against bounds of 3.8 and 1.0 ms on an H100).  The team splits
// each group op's independent products over its members (critical path 3
// products), so the card holds 6 times the warps, and the product runs its
// carries through PTX carry chains with no call frame or local memory.  A
// block is one warp per member over 32 lanes (member-major threads), so
// every global load and store of a warp stays one 128-byte line; the team's
// working set lives in shared memory, 21 field elements per lane (32 KB per
// block at W = 12), with a barrier between steps.  On the H100 K2 takes 9.3
// ms at B 16384 and 4.6 at B 8192, K4 2.4 ms at its first pass, 41-44% of
// the IMAD bound.  The card is then full (the time halves with the lanes);
// each multiply-add issues as a multiply and a carry add, and the carry
// chains, the barriers and the members idle in the smaller steps take the
// rest.  Each lane keeps its order of group ops and each group op its order
// of field ops, so the outputs equal the one-thread kernels'.
//
// K3 adds two batches elementwise, one group op per lane: B 16384 in each
// of the 10 Kogge-Stone rounds of a 2^19 chunk's lane prefix, and B = the
// window count (16) where the chunks' window sums are accumulated.  On one
// thread per lane (a called group op with a
// 328-544 B stack frame) it ran 14 dependent products per lane on about
// one warp per scheduler; on the team its critical path is 3 products,
// the same as K4's per row, with the card holding 6 times the warps.
//
// K5 and K6 have few lanes or one: K5 doubles the MSM's 16 window totals
// 15-16 times, K6 runs one dependent chain of (Wn - 1)(c + 1) group ops
// (255 at Wn 16, c 16).  Neither can fill the card, so what bounds them is
// the chain: 3 dependent products per group op on the team (a doubling
// is the complete add of the point with itself, DBL_1), each a serial
// carry chain, against 14 on one thread, where they ran at ~51 us per
// group op with a called one-thread group op.  The chain bound is the
// products on the critical path times one product's latency
// (blz_product_chain: 1.24 us at W = 12 on an H100).  There K6 takes 1.98
// ms at (Wn 16, c 16), 2.1 times its chain bound (one thread: 12.9 ms),
// and K5 0.123 ms at (B 16, k 16) (one thread: 0.80 ms); the shared-memory
// operands, the lazy adds and the barriers between steps take the rest.
#include <cuda_runtime.h>

#include <cstring>

#include "ec_team.cuh"

namespace {

constexpr int kTeamLanes = 32;       // lanes per team block: one warp per member
using blz::team::kTeam;

template <int W>
constexpr int team_smem_bytes() {
  return blz::team::kSlots * W * 4 * kTeamLanes;
}

// The running point's coordinates go out by the member that computed them
// in step 4 (coordinate k by member k: its own writes, no barrier).
template <int W>
__device__ __forceinline__ void store_coords(uint32_t* dst, int member,
                                             const blz::team::Slots<W, kTeamLanes>& sl,
                                             bool live, int64_t B) {
  if (member < 3) {
    uint32_t v[W];
    sl.load(v, blz::team::X1 + member);
    if (live) {
#pragma unroll
      for (int w = 0; w < W; ++w) dst[(int64_t)(member * W + w) * B] = v[w];
    }
  }
}

template <int W>
__device__ __forceinline__ void team_init(int member,
                                          const blz::team::Slots<W, kTeamLanes>& sl,
                                          const blz::FieldConsts<W>& fc) {
  if (member == 0) {
    uint32_t zero[W];
#pragma unroll
    for (int w = 0; w < W; ++w) zero[w] = 0;
    sl.store(blz::team::X1, zero);
    sl.store(blz::team::Y1, fc.one);
    sl.store(blz::team::Z1, zero);
    sl.store(blz::team::B3, fc.b3);
  }
}

// K2's two operand sources.  A source gives lane `lane`'s point of step c:
// member 0 its X words, member 1 its Y words and (signed) its sign.  The
// source is the kernel's constant parameter; what a thread keeps of it
// between steps is its Cursor, made by start().  The type's name is in the
// kernel's name, and the gathered form's carries its launch counter's key
// (scan_gathered, msm/pippenger.py's main path), so a device trace tells
// the forms apart.
//
// Rows form: row c of (C, 2W [+1 sign row], B) affine Montgomery rows laid
// out by the caller, lane b at column b (coalesced).
struct scan_rows_fetch {
  const uint32_t* rows;

  struct Cursor {};

  __device__ __forceinline__ Cursor start(int64_t, int) const { return {}; }

  template <int W, bool kSigned>
  __device__ __forceinline__ void fetch(Cursor&, uint32_t* pf, uint32_t& sign, int member, int c,
                                        int, int64_t lane, int64_t B) const {
    const uint32_t* row = rows + (int64_t)c * (2 * W + (kSigned ? 1 : 0)) * B + lane;
#pragma unroll
    for (int w = 0; w < W; ++w) pf[w] = __ldg(row + (int64_t)(member * W + w) * B);
    if (kSigned && member == 1) sign = __ldg(row + (int64_t)2 * W * B);
  }
};

// Gathered form: the points read in place through the chunk's sort, so no
// sorted copy is made.  Lane g R + r at step c takes position pos = r C + c
// of window g's sorted order (a pad, pos >= N, repeats position N - 1):
// point i = order[g][pos] of the resident (2W, N) points, its sign bit 0 of
// sortkey[g][i].  Each word is a 4-byte load at column i: 12 32-byte
// sectors a coordinate, against 2 from a points-major (N, 2W) copy; such a
// copy, staged by a transpose kernel in 0.04 ms a 2^19 chunk, took K2 from
// 8.37 to 8.21 ms on the H100 (rows form 8.30), too little for a kernel
// more.  Index i is read one step before its point's words, so those loads
// (issued a step ahead, like the rows form's) never wait on it.
// Positions and indices are 32-bit (G N + R C < 2^31).
struct scan_gathered_fetch {
  const uint32_t* pts;          // (2W, N) lanes-major
  const long long* order;       // (G, N): sorted position -> point
  const long long* sortkey;     // (G, N): the sort keys (read when signed)
  int N;
  int R;

  struct Cursor {
    int first;                  // g N + r C: the lane's first position
    int last;                   // its last real one, g N + N - 1
    int next;                   // the next step's point index
  };

  __device__ __forceinline__ int index(const Cursor& cur, int c) const {
    const int pos = cur.first + c;
    return (int)__ldg(order + (pos < cur.last ? pos : cur.last));
  }

  __device__ __forceinline__ Cursor start(int64_t lane, int C) const {
    const int g = (int)(lane / R);
    Cursor cur{g * N + (int)(lane % R) * C, g * N + N - 1, 0};
    cur.next = index(cur, 0);
    return cur;
  }

  template <int W, bool kSigned>
  __device__ __forceinline__ void fetch(Cursor& cur, uint32_t* pf, uint32_t& sign, int member,
                                        int c, int C, int64_t, int64_t) const {
    const int i = cur.next;
    if (c + 1 < C) cur.next = index(cur, c + 1);
#pragma unroll
    for (int w = 0; w < W; ++w) pf[w] = __ldg(pts + (int64_t)(member * W + w) * N + i);
    if (kSigned && member == 1)
      sign = (uint32_t)(__ldg(sortkey + (cur.last - (N - 1)) + i) & 1);
  }
};

// One source's points (Fetch) -> emitted (C, 3W, B) inclusive prefixes, tot
// (3W, B) the last prefix.  Member 0 fetches X, member 1 Y and the sign,
// one row ahead (the loads of row c + 1 are in flight during row c's last
// products).  Four blocks per SM (80 registers), as the MSM's 16384 lanes
// run: so bounded, ptxas compiles the group ops of both forms alike; left
// free, it gave the gathered form's products 15% more instructions (adds
// of the modulus from uniform registers) and K2 8% more time.
template <int W, bool kSigned, class Fetch>
__global__ void __launch_bounds__(kTeamLanes * kTeam, 4)
scan_mixed_kernel(const Fetch src, uint32_t* __restrict__ emitted, uint32_t* __restrict__ tot,
                  int C, int64_t B, blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const int64_t lane = (int64_t)blockIdx.x * kTeamLanes + l;
  const bool live = lane < B;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  uint32_t pf[W], sign = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) pf[w] = 0;

  typename Fetch::Cursor cur{};
  if (member < 2 && live) cur = src.start(lane, C);
  auto fetch = [&](int c) {
    if (member < 2 && live && c < C)
      src.template fetch<W, kSigned>(cur, pf, sign, member, c, C, lane, B);
  };
  auto put = [&]() {
    if (member < 2) {
      if (kSigned && member == 1 && sign != 0) {
        tm::sub_lazy<W>(pf, fc.p2, pf, fc);   // -Y = 2p - Y (lazy domain)
      }
      sl.store(tm::X2 + member, pf);
    }
  };

  team_init<W>(member, sl, fc);
  fetch(0);
  put();
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    tm::run_step<tm::MIXED_1, W>(member, sl, fc);
    __syncthreads();
    fetch(c + 1);
    tm::run_step<tm::MIXED_2, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_3, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_4, W>(member, sl, fc);
    store_coords<W>(emitted + (int64_t)c * 3 * W * B + lane, member, sl, live, B);
    if (c + 1 < C) put();
    __syncthreads();
  }
  store_coords<W>(tot + lane, member, sl, live, B);
}

// rows (C, 3W, B) -> tot (3W, B): identity + row 0 + ... + row C-1.
// Coordinate k of each row is fetched by member k, one row ahead.
template <int W>
__global__ void __launch_bounds__(kTeamLanes * kTeam)
reduce_cols_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ tot,
                   int C, int64_t B, blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const int64_t lane = (int64_t)blockIdx.x * kTeamLanes + l;
  const bool live = lane < B;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  uint32_t pf[W];
#pragma unroll
  for (int w = 0; w < W; ++w) pf[w] = 0;

  auto fetch = [&](int c) {
    if (member < 3 && live && c < C) {
      const uint32_t* src = rows + ((int64_t)c * 3 * W + member * W) * B + lane;
#pragma unroll
      for (int w = 0; w < W; ++w) pf[w] = src[(int64_t)w * B];
    }
  };
  auto put = [&]() {
    if (member < 3) sl.store(tm::X2 + member, pf);
  };

  team_init<W>(member, sl, fc);
  fetch(0);
  put();
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    tm::run_step<tm::FULL_1, W>(member, sl, fc);
    __syncthreads();
    fetch(c + 1);
    tm::run_step<tm::FULL_2, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_3, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_4, W>(member, sl, fc);
    if (c + 1 < C) put();
    __syncthreads();
  }
  store_coords<W>(tot + lane, member, sl, live, B);
}

// One team's group op: step kFirst (FULL_1 adds X2..Z2, DBL_1 doubles),
// then alg 7's FULL_2, OUT_3 and OUT_4, a barrier after each but the last
// (the caller's, so that it can stage the next operand before it).
template <int kFirst, int W>
__device__ __forceinline__ void team_add_full(int member,
                                              const blz::team::Slots<W, kTeamLanes>& sl,
                                              const blz::FieldConsts<W>& fc) {
  namespace tm = blz::team;
  tm::run_step<kFirst, W>(member, sl, fc);
  __syncthreads();
  tm::run_step<tm::FULL_2, W>(member, sl, fc);
  __syncthreads();
  tm::run_step<tm::OUT_3, W>(member, sl, fc);
  __syncthreads();
  tm::run_step<tm::OUT_4, W>(member, sl, fc);
}

// p, q (3W, B) -> o (3W, B): o = p + q per lane (alg 7), one group op.
// Member k < 3 loads coordinate k of p into X1..Z1 and of q into X2..Z2.
template <int W>
__global__ void __launch_bounds__(kTeamLanes * kTeam)
ec_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ o, int64_t B, blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const int64_t lane = (int64_t)blockIdx.x * kTeamLanes + l;
  const bool live = lane < B;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  if (member < 3) {
    uint32_t a[W], b[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int64_t i = (int64_t)(member * W + w) * B + lane;
      a[w] = live ? p[i] : 0;
      b[w] = live ? q[i] : 0;
    }
    sl.store(tm::X1 + member, a);
    sl.store(tm::X2 + member, b);
  }
  if (member == 3) sl.store(tm::B3, fc.b3);
  __syncthreads();
  team_add_full<tm::FULL_1, W>(member, sl, fc);
  store_coords<W>(o + lane, member, sl, live, B);
}

// (3W, B) -> (3W, B): k doublings per lane, each the complete add of the
// point with itself.  Member k < 3 loads and stores coordinate k.
template <int W>
__global__ void __launch_bounds__(kTeamLanes * kTeam)
dbl_n_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ o, int k, int64_t B,
             blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const int64_t lane = (int64_t)blockIdx.x * kTeamLanes + l;
  const bool live = lane < B;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  if (member < 3) {
    uint32_t v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = live ? p[(int64_t)(member * W + w) * B + lane] : 0;
    sl.store(tm::X1 + member, v);
  }
  if (member == 0) sl.store(tm::B3, fc.b3);
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    team_add_full<tm::DBL_1, W>(member, sl, fc);
    __syncthreads();
  }
  store_coords<W>(o + lane, member, sl, live, B);
}

// ws (3W, Wn) window sums -> o (3W, 1): sum_w 2^(c w) ws[:, w], in the step
// order of kernels.py:_fold_fn (step s: r = s / (c+1), pos = s % (c+1);
// pos == c adds window Wn-2-r, else doubles), at least one step.  One lane,
// one team, one warp per member: the 32 threads of a warp run 32 copies of
// the lane (as fast as one) and lane 0 stores the sum.  On the H100 this
// beat the team of 6 in one warp (its members diverge in step 2) and a
// team of 3 (PERF.md).  The window sums are staged in shared memory once;
// member k < 3 puts coordinate k of the next window into X2..Z2 during the
// last step of the group op before its add.
template <int W>
__global__ void __launch_bounds__(kTeamLanes * kTeam)
fold_horner_kernel(const uint32_t* __restrict__ ws, uint32_t* __restrict__ o, int c, int Wn,
                   blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  uint32_t* win = (uint32_t*)(team_smem + tm::kSlots * (W / 4) * kTeamLanes);   // (Wn, 3W)
  for (int i = threadIdx.x; i < 3 * W * Wn; i += kTeamLanes * kTeam)
    win[i] = ws[(int64_t)(i % (3 * W)) * Wn + i / (3 * W)];
  __syncthreads();
  auto put = [&](int slot, int w) {
    if (member < 3) sl.store(slot + member, win + (w * 3 + member) * W);
  };
  const int steps = max((Wn - 1) * (c + 1), 1);
  put(tm::X1, Wn - 1);
  if (member == 0) sl.store(tm::B3, fc.b3);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s % (c + 1) == c) {
      team_add_full<tm::FULL_1, W>(member, sl, fc);
    } else {
      team_add_full<tm::DBL_1, W>(member, sl, fc);
    }
    const int n = s + 1;
    if (n < steps && n % (c + 1) == c) put(tm::X2, Wn - 2 - n / (c + 1));
    __syncthreads();
  }
  store_coords<W>(o, member, sl, l == 0, 1);
}

// One thread: n dependent lazy products x <- x y (carry.cuh), the latency
// of one product on K5's and K6's critical path.
template <int W>
__global__ void product_chain_kernel(const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ y, uint32_t* __restrict__ o,
                                     int n, blz::FieldConsts<W> fc) {
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = x[w];
    b[w] = y[w];
  }
  for (int i = 0; i < n; ++i) blz::mont_mul_cc<W, true>(a, a, b, fc);
#pragma unroll
  for (int w = 0; w < W; ++w) o[w] = a[w];
}

unsigned team_blocks(int64_t B) { return (unsigned)((B + kTeamLanes - 1) / kTeamLanes); }

template <int W, class Fetch>
int scan(int is_signed, const uint32_t* consts, const Fetch& src, void* emitted, void* tot,
         int C, int64_t B, cudaStream_t s) {
  const auto fc = blz::load_consts<W>(consts);
  const auto e = (uint32_t*)emitted;
  const auto t = (uint32_t*)tot;
  if (is_signed) {
    scan_mixed_kernel<W, true, Fetch>
        <<<team_blocks(B), kTeamLanes * kTeam, team_smem_bytes<W>(), s>>>(src, e, t, C, B, fc);
  } else {
    scan_mixed_kernel<W, false, Fetch>
        <<<team_blocks(B), kTeamLanes * kTeam, team_smem_bytes<W>(), s>>>(src, e, t, C, B, fc);
  }
  return (int)cudaGetLastError();
}

template <int W>
int add(const uint32_t* consts, const void* p, const void* q, void* o, int64_t B,
        cudaStream_t s) {
  ec_add_kernel<W><<<team_blocks(B), kTeamLanes * kTeam, team_smem_bytes<W>(), s>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)o, B,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int reduce(const uint32_t* consts, const void* rows, void* tot, int C, int64_t B,
           cudaStream_t s) {
  reduce_cols_kernel<W><<<team_blocks(B), kTeamLanes * kTeam, team_smem_bytes<W>(), s>>>(
      (const uint32_t*)rows, (uint32_t*)tot, C, B, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int dbl(const uint32_t* consts, const void* p, void* o, int k, int64_t B, cudaStream_t s) {
  dbl_n_kernel<W><<<team_blocks(B), kTeamLanes * kTeam, team_smem_bytes<W>(), s>>>(
      (const uint32_t*)p, (uint32_t*)o, k, B, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

// K6's shared memory: the team's slots and the Wn window sums (past 48 KB
// for W = 12 beyond 117 windows: c <= 2).
template <int W>
int fold(const uint32_t* consts, const void* ws, void* o, int c, int Wn, cudaStream_t s) {
  const int smem = team_smem_bytes<W>() + 3 * W * Wn * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_horner_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  fold_horner_kernel<W><<<1, kTeamLanes * kTeam, smem, s>>>(
      (const uint32_t*)ws, (uint32_t*)o, c, Wn, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int chain(const uint32_t* consts, const void* x, const void* y, void* o, int n,
          cudaStream_t s) {
  product_chain_kernel<W><<<1, 1, 0, s>>>((const uint32_t*)x, (const uint32_t*)y,
                                          (uint32_t*)o, n, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int blz_scan_mixed(int W, const uint32_t* consts, int is_signed,
                              const void* rows, void* emitted, void* tot, int C,
                              int64_t B, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  auto s = (cudaStream_t)stream;
  const scan_rows_fetch src{(const uint32_t*)rows};
  switch (W) {
    case 8: return scan<8>(is_signed, consts, src, emitted, tot, C, B, s);
    case 12: return scan<12>(is_signed, consts, src, emitted, tot, C, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 on points read through a sort: lane g R + r (G R lanes) scans
// positions r C .. r C + C - 1 of window g's order (G, N), int64, of the
// resident points (2W, N); signed: sign bit 0 of sortkey (G, N), int64.
// Needs R C >= N (positions past N - 1 repeat it) and G N + R C < 2^31.
extern "C" int blz_scan_gathered(int W, const uint32_t* consts, int is_signed, const void* pts,
                                 const void* order, const void* sortkey, void* emitted,
                                 void* tot, int64_t N, int G, int R, int C, void* stream) {
  if (G <= 0 || R <= 0 || C <= 0) return 0;
  if (N <= 0 || (int64_t)R * C < N || (int64_t)G * N + (int64_t)R * C >= (int64_t(1) << 31) ||
      (is_signed && sortkey == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const scan_gathered_fetch src{(const uint32_t*)pts, (const long long*)order,
                                (const long long*)sortkey, (int)N, R};
  const int64_t B = (int64_t)G * R;
  switch (W) {
    case 8: return scan<8>(is_signed, consts, src, emitted, tot, C, B, s);
    case 12: return scan<12>(is_signed, consts, src, emitted, tot, C, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_ec_add(int W, const uint32_t* consts, const void* p,
                          const void* q, void* o, int64_t B, void* stream) {
  if (B <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return add<8>(consts, p, q, o, B, s);
    case 12: return add<12>(consts, p, q, o, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_reduce_cols(int W, const uint32_t* consts, const void* rows,
                               void* tot, int C, int64_t B, void* stream) {
  if (B <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return reduce<8>(consts, rows, tot, C, B, s);
    case 12: return reduce<12>(consts, rows, tot, C, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_dbl_n(int W, const uint32_t* consts, const void* p, void* o,
                         int k, int64_t B, void* stream) {
  if (B <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return dbl<8>(consts, p, o, k, B, s);
    case 12: return dbl<12>(consts, p, o, k, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_fold_horner(int W, const uint32_t* consts, const void* ws,
                               void* o, int c, int Wn, void* stream) {
  if (Wn <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return fold<8>(consts, ws, o, c, Wn, s);
    case 12: return fold<12>(consts, ws, o, c, Wn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One thread, n dependent lazy products o = x y^n / R^n: the latency of one
// product (K5's and K6's chain bound).
extern "C" int blz_product_chain(int W, const uint32_t* consts, const void* x, const void* y,
                                 void* o, int n, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return chain<8>(consts, x, y, o, n, s);
    case 12: return chain<12>(consts, x, y, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Threads that compute one lane of the named kernel as launched above, -1
// for a name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  if (!strcmp(kernel, "scan_mixed") || !strcmp(kernel, "scan_gathered") ||
      !strcmp(kernel, "ec_add") || !strcmp(kernel, "reduce_cols") ||
      !strcmp(kernel, "dbl_n") || !strcmp(kernel, "fold_horner"))
    return kTeam;
  return -1;
}
