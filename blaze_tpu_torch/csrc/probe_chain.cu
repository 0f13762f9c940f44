// Chains of probe bodies (E2-E5): the field product's parts timed one by one.
//
// Replaces the pallas_calls of the four probe scripts under experiments/:
//   redc_probe.py:66      make_chain(body, M)  (E2: M dependent steps per tile)
//   vpu_mul_probe.py:81   make_chain(body, M)  (E3: the same over u32mul,
//                                              mont_u32, conv_u32, conv_f32)
//   mul_kernel_bench.py:83 make_fn(kind, R)    (E4: S independent streams x R)
//   kernel_variants.py:46 make(body_fn, n_in)  (E5: one launch of a body)
// Their bodies are the port's own (probe.cuh); E5's mixed-add body runs on
// ec_team.cuh's team of six, as K2 runs it (probe_mixed_kernel).
//
// probe_chain_kernel<W, kBody, S>: one lane per thread, S independent
// streams per thread; each stream runs M dependent steps x <- body(x, b) and
// is stored, so no step can be dropped.  M is a runtime count (the loop is
// not unrolled): a body's instructions appear once in the SASS and the time
// grows with M, and the slope between two M separates the cost of a step
// from the launch.  S is a template count: the SASS of a step grows with S.
// Layout: x and o (S N, W) words (stream s at rows s N .. s N + N - 1), b
// (N, W), lane i reads 4W contiguous bytes of each.
//
// What bounds it: a body's instructions per step, IMAD for the products and
// REDC, IADD3 for the carries, FFMA for conv_f32; with 2^20 lanes the card
// holds as many warps as the registers allow, so a chain measures issue
// rate unless too few warps fit to hide its latency (S = 4 against S = 1
// tells which).
#include <cuda_runtime.h>

#include <cstring>

#include "ec_team.cuh"
#include "probe.cuh"

namespace {

namespace pb = blz::probe;

constexpr int kThreads = 128;

template <int W, int kBody, int S>
__global__ void __launch_bounds__(kThreads)
probe_chain_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ o, int64_t N, int M, blz::FieldConsts<W> fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t v[S][W], y[W];
#pragma unroll
  for (int w = 0; w < W; ++w) y[w] = b[i * W + w];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int w = 0; w < W; ++w) v[s][w] = x[(s * N + i) * W + w];
  }
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) pb::step<W, kBody>(v[s], y, fc);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int w = 0; w < W; ++w) o[(s * N + i) * W + w] = v[s][w];
  }
}

// E5's mixed-add body (RCB 2016 alg 8, lazy < 2p) M times per lane on the
// team of six: p (3W, B) projective, q (2W, B) affine, o (3W, B) the
// running point after M adds of q, lanes-major as K2's rows.  The steps and
// the barriers between them are scan_mixed_kernel's (ec_kernels.cu).
constexpr int kTeamLanes = 32;
using blz::team::kTeam;

template <int W>
__global__ void __launch_bounds__(kTeamLanes * kTeam)
probe_chain_mixed_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                         uint32_t* __restrict__ o, int64_t B, int M, blz::FieldConsts<W> fc) {
  namespace tm = blz::team;
  extern __shared__ uint4 team_smem[];
  const int member = threadIdx.x / kTeamLanes;
  const int l = threadIdx.x % kTeamLanes;
  const int64_t lane = (int64_t)blockIdx.x * kTeamLanes + l;
  const bool live = lane < B;
  const tm::Slots<W, kTeamLanes> sl{team_smem + l};
  uint32_t v[W];
  if (member < 5) {             // X1, Y1, Z1 from p, X2, Y2 from q
    const uint32_t* src = member < 3 ? p + (int64_t)member * W * B
                                     : q + (int64_t)(member - 3) * W * B;
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = live ? src[(int64_t)w * B + lane] : 0;
    sl.store(member < 3 ? tm::X1 + member : tm::X2 + member - 3, v);
  } else {
    sl.store(tm::B3, fc.b3);
  }
  __syncthreads();
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    tm::run_step<tm::MIXED_1, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::MIXED_2, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_3, W>(member, sl, fc);
    __syncthreads();
    tm::run_step<tm::OUT_4, W>(member, sl, fc);
    __syncthreads();
  }
  if (member < 3 && live) {
    sl.load(v, tm::X1 + member);
#pragma unroll
    for (int w = 0; w < W; ++w) o[(int64_t)(member * W + w) * B + lane] = v[w];
  }
}

template <int W, int kBody, int S>
int chain(const uint32_t* consts, const void* x, const void* b, void* o, int64_t N, int M,
          cudaStream_t s) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  probe_chain_kernel<W, kBody, S><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const uint32_t*)x, (const uint32_t*)b, (uint32_t*)o, N, M, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

// The (body, S) pairs built: every body at S = 1, E4's four and the three
// multiply forms also at S = 4.
template <int W>
int chain_w(int body, int S, const uint32_t* consts, const void* x, const void* b, void* o,
            int64_t N, int M, cudaStream_t s) {
#define BLZ_CHAIN(k)                                                     \
  case pb::k:                                                            \
    return S == 1 ? chain<W, pb::k, 1>(consts, x, b, o, N, M, s)         \
                  : (int)cudaErrorInvalidValue;
#define BLZ_CHAIN4(k)                                                    \
  case pb::k:                                                            \
    return S == 1   ? chain<W, pb::k, 1>(consts, x, b, o, N, M, s)       \
           : S == 4 ? chain<W, pb::k, 4>(consts, x, b, o, N, M, s)       \
                    : (int)cudaErrorInvalidValue;
  switch (body) {
    BLZ_CHAIN4(kMont)
    BLZ_CHAIN4(kConv)
    BLZ_CHAIN(kCarry)
    BLZ_CHAIN4(kRedc)
    BLZ_CHAIN4(kAddF)
    BLZ_CHAIN(kSubF)
    BLZ_CHAIN4(kMulLo)
    BLZ_CHAIN4(kMulHi)
    BLZ_CHAIN4(kMulWide)
    BLZ_CHAIN(kConvF32)
    BLZ_CHAIN(kMont11)
    BLZ_CHAIN(kGlue15)
    BLZ_CHAIN(kMontHi)
    BLZ_CHAIN(kMontRz)
    BLZ_CHAIN(kMontComba)
    BLZ_CHAIN(kMontSplit)
    BLZ_CHAIN(kMontWide)
    BLZ_CHAIN(kMontPair64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BLZ_CHAIN
#undef BLZ_CHAIN4
}

template <int W>
int mixed(const uint32_t* consts, const void* p, const void* q, void* o, int64_t B, int M,
          cudaStream_t s) {
  const unsigned blocks = (unsigned)((B + kTeamLanes - 1) / kTeamLanes);
  const int smem = blz::team::kSlots * W * 4 * kTeamLanes;
  probe_chain_mixed_kernel<W><<<blocks, kTeamLanes * kTeam, smem, s>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)o, B, M, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int blz_probe_chain(int W, int body, int S, const uint32_t* consts, const void* x,
                               const void* b, void* o, int64_t N, int M, void* stream) {
  if (N <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return chain_w<8>(body, S, consts, x, b, o, N, M, s);
    case 12: return chain_w<12>(body, S, consts, x, b, o, N, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_probe_mixed(int W, const uint32_t* consts, const void* p, const void* q,
                               void* o, int64_t B, int M, void* stream) {
  if (B <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return mixed<8>(consts, p, q, o, B, M, s);
    case 12: return mixed<12>(consts, p, q, o, B, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Threads that compute one lane of the named kernel (the chain's; the
// mixed-add body runs a team of kTeam per lane), -1 for a name not here.
extern "C" int blz_threads_per_lane(const char* kernel) {
  if (!strcmp(kernel, "probe_chain")) return 1;
  if (!strcmp(kernel, "probe_chain_mixed")) return kTeam;
  return -1;
}
