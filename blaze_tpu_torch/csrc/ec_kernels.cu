// K2-K6: the MSM's EC kernels, lanes-major (rows of words x lanes).
//
// A batch of projective points is (3W, B) words: X words in rows 0..W-1,
// Y in W..2W-1, Z in 2W..3W-1, lane b at column b — neighbouring threads
// touch neighbouring words, so every load and store of a warp is one
// coalesced 128-byte line.  All values stay in the lazy < 2p range.
//
// Replaces (blaze_tpu/curves/kernels.py, ECKernels):
//   K2 blz_scan_mixed  <- _scan_fn / scan_mixed   (per-lane prefix of mixed adds)
//   K3 blz_ec_add      <- _add_fn / add           (batched complete add)
//   K4 blz_reduce_cols <- _reduce_fn / reduce_cols (lane-wise sum over rows)
//   K5 blz_dbl_n       <- _dbl_fn / dbl_n         (k doublings per lane)
//   K6 blz_fold_horner <- _fold_fn / fold_horner  (Horner window fold)
//
// Bound on the H100: integer multiply-adds (13 or 14 Montgomery products
// per group op, each 2 * (2W^2 + W) IMADs).  On the TPU the sequential axis
// was a grid axis with the running sum in VMEM scratch; here it is a loop
// inside one thread with the running sum in registers, and the lanes are
// the parallel axis.  Where the lane count is small (the MSM scan has
// G * R = 16384 lanes at a 2^19 chunk, about one 128-thread block per SM)
// the kernels are latency-bound: each thread's chain of dependent products
// is the critical path and the SMs hold few warps to hide it.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

constexpr int kThreads = 128;

template <int W>
__device__ __forceinline__ void load_point(blz::Point<W>& p, const uint32_t* src,
                                           int64_t stride) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    p.x[k] = src[k * stride];
    p.y[k] = src[(W + k) * stride];
    p.z[k] = src[(2 * W + k) * stride];
  }
}

template <int W>
__device__ __forceinline__ void store_point(uint32_t* dst, const blz::Point<W>& p,
                                            int64_t stride) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    dst[k * stride] = p.x[k];
    dst[(W + k) * stride] = p.y[k];
    dst[(2 * W + k) * stride] = p.z[k];
  }
}

// rows (C, 2W [+1 sign row], B) affine Montgomery -> emitted (C, 3W, B)
// inclusive prefixes, tot (3W, B) the last prefix.
template <int W, bool kSigned>
__global__ void __launch_bounds__(kThreads)
scan_mixed_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ emitted,
                  uint32_t* __restrict__ tot, int C, int64_t B,
                  blz::FieldConsts<W> fc) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  constexpr int kRows = 2 * W + (kSigned ? 1 : 0);
  blz::Point<W> acc;
  blz::set_identity<W>(acc, fc);
  for (int c = 0; c < C; ++c) {
    const uint32_t* row = rows + (int64_t)c * kRows * B + lane;
    uint32_t x2[W], y2[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      x2[k] = row[k * B];
      y2[k] = row[(W + k) * B];
    }
    if (kSigned && row[2 * W * B] != 0) {
      blz::fsub<W, true>(y2, fc.p2, y2, fc);   // -Y = 2p - Y (lazy domain)
    }
    blz::ec_add_mixed<W>(acc, acc, x2, y2, fc);
    store_point<W>(emitted + (int64_t)c * 3 * W * B + lane, acc, B);
  }
  store_point<W>(tot + lane, acc, B);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
ec_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ o, int64_t B, blz::FieldConsts<W> fc) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  blz::Point<W> a, b;
  load_point<W>(a, p + lane, B);
  load_point<W>(b, q + lane, B);
  blz::ec_add_full<W>(a, a, b, fc);
  store_point<W>(o + lane, a, B);
}

// rows (C, 3W, B) -> tot (3W, B): identity + row 0 + ... + row C-1.
template <int W>
__global__ void __launch_bounds__(kThreads)
reduce_cols_kernel(const uint32_t* __restrict__ rows, uint32_t* __restrict__ tot,
                   int C, int64_t B, blz::FieldConsts<W> fc) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  blz::Point<W> acc, q;
  blz::set_identity<W>(acc, fc);
  for (int c = 0; c < C; ++c) {
    load_point<W>(q, rows + (int64_t)c * 3 * W * B + lane, B);
    blz::ec_add_full<W>(acc, acc, q, fc);
  }
  store_point<W>(tot + lane, acc, B);
}

// (3W, B) -> (3W, B): k doublings, each the complete add of a point with itself.
template <int W>
__global__ void __launch_bounds__(kThreads)
dbl_n_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ o, int k,
             int64_t B, blz::FieldConsts<W> fc) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  blz::Point<W> acc;
  load_point<W>(acc, p + lane, B);
  for (int s = 0; s < k; ++s) blz::ec_add_full<W>(acc, acc, acc, fc);
  store_point<W>(o + lane, acc, B);
}

// ws (3W, Wn) window sums -> o (3W, 1): sum_w 2^(c w) ws[:, w], one thread,
// in the step order of kernels.py:_fold_fn (step s: r = s / (c+1),
// pos = s % (c+1); pos == c adds window Wn-2-r, else doubles).
template <int W>
__global__ void fold_horner_kernel(const uint32_t* __restrict__ ws,
                                   uint32_t* __restrict__ o, int c, int Wn,
                                   blz::FieldConsts<W> fc) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  blz::Point<W> acc, q;
  load_point<W>(acc, ws + (Wn - 1), Wn);
  int steps = (Wn - 1) * (c + 1);
  if (steps < 1) steps = 1;
  for (int s = 0; s < steps; ++s) {
    const int r = s / (c + 1);
    const int pos = s % (c + 1);
    if (pos == c) {
      load_point<W>(q, ws + (Wn - 2 - r), Wn);
      blz::ec_add_full<W>(acc, acc, q, fc);
    } else {
      blz::ec_add_full<W>(acc, acc, acc, fc);
    }
  }
  store_point<W>(o, acc, 1);
}

unsigned blocks_for(int64_t B) { return (unsigned)((B + kThreads - 1) / kThreads); }

template <int W>
int scan(int is_signed, const uint32_t* consts, const void* rows, void* emitted,
         void* tot, int C, int64_t B, cudaStream_t s) {
  const auto fc = blz::load_consts<W>(consts);
  if (is_signed) {
    scan_mixed_kernel<W, true><<<blocks_for(B), kThreads, 0, s>>>(
        (const uint32_t*)rows, (uint32_t*)emitted, (uint32_t*)tot, C, B, fc);
  } else {
    scan_mixed_kernel<W, false><<<blocks_for(B), kThreads, 0, s>>>(
        (const uint32_t*)rows, (uint32_t*)emitted, (uint32_t*)tot, C, B, fc);
  }
  return (int)cudaGetLastError();
}

template <int W>
int add(const uint32_t* consts, const void* p, const void* q, void* o, int64_t B,
        cudaStream_t s) {
  ec_add_kernel<W><<<blocks_for(B), kThreads, 0, s>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)o, B,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int reduce(const uint32_t* consts, const void* rows, void* tot, int C, int64_t B,
           cudaStream_t s) {
  reduce_cols_kernel<W><<<blocks_for(B), kThreads, 0, s>>>(
      (const uint32_t*)rows, (uint32_t*)tot, C, B, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int dbl(const uint32_t* consts, const void* p, void* o, int k, int64_t B,
        cudaStream_t s) {
  dbl_n_kernel<W><<<blocks_for(B), kThreads, 0, s>>>(
      (const uint32_t*)p, (uint32_t*)o, k, B, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int fold(const uint32_t* consts, const void* ws, void* o, int c, int Wn,
         cudaStream_t s) {
  fold_horner_kernel<W><<<1, 1, 0, s>>>((const uint32_t*)ws, (uint32_t*)o, c, Wn,
                                        blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int blz_scan_mixed(int W, const uint32_t* consts, int is_signed,
                              const void* rows, void* emitted, void* tot, int C,
                              int64_t B, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return scan<8>(is_signed, consts, rows, emitted, tot, C, B, s);
    case 12: return scan<12>(is_signed, consts, rows, emitted, tot, C, B, s);
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
