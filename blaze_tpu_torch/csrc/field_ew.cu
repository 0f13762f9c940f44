// KF: elementwise canonical field ops on (M, W) 32-bit words: add, sub,
// neg, double, and canon (the conditional subtraction of p, with an
// optional carry word per element).
//
// The port's own kernel, not the counterpart of a pallas_call: blaze_tpu
// computes these as XLA elementwise ops (blaze_tpu/fields/mont.py
// Field._cond_sub_p / add / sub / neg / double), which XLA fuses into the
// MSM chunk's one program (blaze_tpu/msm/pippenger.py _msm_fused_jit).
// In the port each was ~50 int64 torch ops (fields/elementwise.py
// field_ew_plain, the Kogge-Stone carries); here it is one launch.
//
// Bound on the H100: bytes (each operand read once, the result written
// once, W x 4 B per element; a few carry instructions per word), and for
// the MSM chunk's few-element calls the launch itself.  Design: one
// thread per element, its words in registers, the word-serial carry and
// borrow chains of carry.cuh (add.cc / addc / sub.cc / subc; field_ew.cuh).
// The constants travel in the kernel's arguments (load_consts at launch),
// so a CUDA graph that captures a launch keeps them.
#include <cuda_runtime.h>

#include <cstring>

#include "field_ew.cuh"

namespace {

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
field_ew_kernel(int op, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                const int32_t* __restrict__ top, uint32_t* __restrict__ o, int64_t M,
                blz::FieldConsts<W> fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t x[W], y[W], r[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = a[i * W + k];
  if (op == blz::kEwAdd || op == blz::kEwSub) {
#pragma unroll
    for (int k = 0; k < W; ++k) y[k] = b[i * W + k];
  }
  const uint32_t t = top != nullptr ? (uint32_t)top[i] : 0u;
  blz::field_ew_element<W>(op, r, x, y, t, fc);
#pragma unroll
  for (int k = 0; k < W; ++k) o[i * W + k] = r[k];
}

template <int W>
int launch(const uint32_t* consts, int op, const void* a, const void* b, const void* top,
           void* o, int64_t M, cudaStream_t stream) {
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  field_ew_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      op, (const uint32_t*)a, (const uint32_t*)b, (const int32_t*)top, (uint32_t*)o, M,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// o = op(a, b) over M elements of W words on `stream`; b is read by add and
// sub only, `top` (M int32, nonzero: a carry word above the element; may
// be null) by canon only.  Returns cudaGetLastError() (0 = ok).
extern "C" int blz_field_ew(int W, const uint32_t* consts, int op, const void* a,
                            const void* b, const void* top, void* o, int64_t M,
                            void* stream) {
  if (op < blz::kEwAdd || op > blz::kEwCanon) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  switch (W) {
    case 8:
      return launch<8>(consts, op, a, b, top, o, M, (cudaStream_t)stream);
    case 12:
      return launch<12>(consts, op, a, b, top, o, M, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Threads that compute one lane (one element) of the named kernel, -1 for
// a name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  return strcmp(kernel, "field_ew") ? -1 : 1;
}
