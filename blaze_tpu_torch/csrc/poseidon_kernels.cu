// K10: the whole Poseidon permutation of (t, W, B) lanes-major states.
//
// Replaces blaze_tpu/hash/kernels.py PoseidonKernels._perm_fn (the
// pallas_call at :207) behind permute_lm: r_f/2 full rounds, r_p partial
// rounds, r_f/2 full rounds of ARK, x^5 S-box and MDS mix, with the
// optional canonical -> Montgomery conversion of the input (convert_in).
// Every value stays canonical (< p), so the output words equal the TPU
// kernel's (and the dense plain version's) whatever the schedule.  The TPU
// kernel's byte-plane int8 matmul for the MDS and its 128-lane padding are
// TPU workarounds left out.
//
// Bound on the H100: 32-bit integer multiply-adds (the bytes, 768 B per
// t = 12 state read and written, are ~0.1% of the time).  The work is cut
// first: the partial rounds run sparse (poseidon.cuh, hash/params.py
// SparseForm), a mix of t + (t - 1) products where the TPU kernel's is t^2,
// about 0.56 M IMADs per t = 12 state (r_p 60) and 0.41 M per t = 9 state
// (r_p 63) at W = 8, from 1.49 M and 0.93 M.  Every product is a PTX carry
// chain (carry.cuh).
//
// Design: one thread per state, 64 states per block.  A state is t W words
// (96 at t = 12, W = 8), and a dense mix needs the old state while it
// writes the new one, so each thread has two columns in shared memory
// ([(e * W + w) * S + thread] for S states per block: neighbouring threads
// on neighbouring banks), 2 t W 4 S B per block (48 KB at t = 12, W = 8: 8
// warps per SM; 102 KB at t = 17, W = 12, the widest state of the
// reference's table over a 12-word field); a sparse partial round runs in
// place on one.  A width whose columns do not fit 227 KB at 64 states gets
// fewer states per block.  On the H100 this beat a state held in
// registers (244 registers at t = 12, and unrolled round bodies) and one
// shared column with the mixes' rows in device memory (up to 18 warps per
// SM); reading the constants through the constant bank was slower than the
// read-only path (PERF.md, PR 5).  Loads and stores of the state in device
// memory are coalesced ((e, w, b) at (e * W + w) * B + b).  Each thread
// reads its whole state before it writes any of it, so the kernel may run
// in place (o == x).  The constants come by pointer, so back-to-back
// launches of different instances never share a constant symbol.
#include <cuda_runtime.h>

#include <cstring>

#include "poseidon.cuh"

namespace {

constexpr int kStates = 64;              // states per block, at most
constexpr size_t kMaxSmem = 232448;      // shared memory a block may use (227 KB)

template <int W>
__global__ void __launch_bounds__(kStates)
poseidon_perm_kernel(const uint32_t* x, uint32_t* o, int64_t B, int convert_in,
                     const uint32_t* __restrict__ pc, blz::PoseidonShape sh,
                     blz::FieldConsts<W> fc) {
  extern __shared__ uint32_t sm[];
  const int S = blockDim.x;
  const int64_t b = (int64_t)blockIdx.x * S + threadIdx.x;
  if (b >= B) return;                    // no barrier below: threads are independent
  const int words = sh.t * W;
  uint32_t* cur = sm + threadIdx.x;
  uint32_t* nxt = cur + words * S;
  for (int i = 0; i < words; ++i) cur[i * S] = x[(int64_t)i * B + b];
  const uint32_t* res = blz::poseidon_permute<W>(cur, nxt, S, convert_in != 0, pc, sh, fc);
  for (int i = 0; i < words; ++i) o[(int64_t)i * B + b] = res[i * S];
}

// The states per block (64, or the most whose two columns fit), 0 when
// not even one state fits.
int states_per_block(int t, int W) {
  int S = kStates;
  while (S > 0 && (size_t)2 * t * W * 4 * S > kMaxSmem) S /= 2;
  return S;
}

template <int W>
int launch(const uint32_t* consts, const void* pc, const blz::PoseidonShape& sh,
           const void* x, void* o, int64_t B, int convert_in, cudaStream_t stream) {
  const int S = states_per_block(sh.t, W);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * sh.t * W * S * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      poseidon_perm_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (B + S - 1) / S;
  poseidon_perm_kernel<W><<<(unsigned)blocks, S, smem, stream>>>(
      (const uint32_t*)x, (uint32_t*)o, B, convert_in, (const uint32_t*)pc, sh,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

// The multi-p REDC on its own, for checks: o[:, b] = (sum_j a[j, :, b] *
// c[j, :, b]) / R mod p for t pairs of canonical (t, W, B) inputs — one MDS
// row's work (carry.cuh mul_acc_cc + redc_sum).
template <int W>
__global__ void __launch_bounds__(256)
sum_products_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ c,
                    uint32_t* __restrict__ o, int t, int64_t B,
                    const uint32_t* __restrict__ mults, int nm, blz::FieldConsts<W> fc) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t acc[2 * W + 1], x[W], y[W];
#pragma unroll
  for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
  for (int j = 0; j < t; ++j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x[w] = a[((int64_t)j * W + w) * B + b];
      y[w] = c[((int64_t)j * W + w) * B + b];
    }
    blz::mul_acc_cc<W>(acc, x, y);
  }
  blz::redc_sum<W>(x, acc, fc, mults, nm);
#pragma unroll
  for (int w = 0; w < W; ++w) o[(int64_t)w * B + b] = x[w];
}

}  // namespace

// consts: the host FieldConsts block; pc: the instance's device constant
// block (poseidon.cuh), laid out for the sparse schedule when sparse != 0.
// 8-word fields (every scalar field the clients hash over) and 12-word
// fields (the base fields) are instantiated; any other W is refused.
extern "C" int blz_poseidon_perm(int W, const uint32_t* consts, const void* pc, int t,
                                 int r_f, int r_p, int nm, int sparse, const void* x, void* o,
                                 int64_t B, int convert_in, void* stream) {
  if (B <= 0) return 0;
  if (t < 2 || nm < 1 || r_f < 0 || r_p < 0 || (sparse && (r_f < 2 || r_p < 1)))
    return (int)cudaErrorInvalidValue;
  const blz::PoseidonShape sh{t, r_f, r_p, nm, sparse != 0};
  const auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return launch<8>(consts, pc, sh, x, o, B, convert_in, s);
    case 12: return launch<12>(consts, pc, sh, x, o, B, convert_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int W>
int sum_launch(const uint32_t* consts, const void* a, const void* c, void* o, int t,
               int64_t B, const void* mults, int nm, cudaStream_t stream) {
  const int64_t blocks = (B + 255) / 256;
  sum_products_kernel<W><<<(unsigned)blocks, 256, 0, stream>>>(
      (const uint32_t*)a, (const uint32_t*)c, (uint32_t*)o, t, B, (const uint32_t*)mults,
      nm, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

// mults: device pointer to the nm multiples 2^b p (W+1 words each).
extern "C" int blz_sum_products(int W, const uint32_t* consts, const void* a, const void* c,
                                void* o, int t, int64_t B, const void* mults, int nm,
                                void* stream) {
  if (B <= 0) return 0;
  if (t < 1 || nm < 1) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return sum_launch<8>(consts, a, c, o, t, B, mults, nm, s);
    case 12: return sum_launch<12>(consts, a, c, o, t, B, mults, nm, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Threads that compute one lane (one state) of the named kernel, -1 for a
// name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  return strcmp(kernel, "poseidon_perm") ? -1 : 1;
}
