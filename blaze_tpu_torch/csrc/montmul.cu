// K1: batched canonical Montgomery product, (M, W) x (M, W) -> (M, W) < p.
//
// Replaces blaze_tpu/fields/mxu.py MXUMont.mul2d (kernel body _kernel),
// reached through mont_mul_mxu from Field.mul.
//
// Bound on the H100: integer multiply-adds (2 * (2W^2 + W) 32-bit IMADs per
// product) for large batches; for the small batches of the curve glue
// (tens of elements) the launch itself.  Design: one thread per product,
// operands and the CIOS accumulator in registers; each thread reads its two
// rows of W contiguous words, so a warp reads 32 * 4W contiguous bytes.
#include <cuda_runtime.h>

#include <cstring>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ o, int64_t M, blz::FieldConsts<W> fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[W], y[W], r[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = a[i * W + k];
    y[k] = b[i * W + k];
  }
  blz::mont_mul<W, false>(r, x, y, fc);
#pragma unroll
  for (int k = 0; k < W; ++k) o[i * W + k] = r[k];
}

template <int W>
int launch(const uint32_t* consts, const void* a, const void* b, void* o,
           int64_t M, cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  mont_mul_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)o, M,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blz_mont_mul(int W, const uint32_t* consts, const void* a,
                            const void* b, void* o, int64_t M, void* stream) {
  if (M <= 0) return 0;
  switch (W) {
    case 8:
      return launch<8>(consts, a, b, o, M, (cudaStream_t)stream);
    case 12:
      return launch<12>(consts, a, b, o, M, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Threads that compute one lane (one product) of the named kernel, -1 for a
// name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  return strcmp(kernel, "mont_mul") ? -1 : 1;
}
