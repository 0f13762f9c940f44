// K7-K9: the NTT's kernels, canonical.
//
// Every value stays canonical (< p): the scalar fields have R < 4p, so the
// lazy < 2p discipline of the EC kernels is unsound here.  Each kernel is
// built at W = 8 (the scalar fields) and W = 12 (bls12_377_fq).  K7 and K9
// work on element-contiguous buffers (an element's W words are 32 or 48
// consecutive bytes, one or one and a half sectors of device memory); K8 on
// (M, W, N) lanes-major words, which FusedNTT hands it as element rows,
// (n, W, 1).
//
// Replaces (blaze_tpu/ntt/kernels.py, NTTKernels):
//   K7 blz_ntt_base    <- _ntt_fn / ntt_base      (whole K-point DIT NTT per lane)
//   K8 blz_mul_lm      <- _mul_fn / mul_lm        (elementwise x*y[*z])
//   K9 blz_twiddle_mul <- _twmul_fn / twiddle_mul (y * T1[v, jo] * T2[v, jl])
//
// Bound on the H100: the FMA pipe's slots of K0's product (carry.cuh
// mont_mul_cc, the one product of every kernel), counted as 4W^2 + W
// IMADs a product (its SASS takes 744 slots at W = 12); K7 does (K/2) log2 K - (K - 1) products per K points (a
// butterfly whose twiddle is W^0 needs none: all of stage 0, K/2^(s+1) of
// stage s), K9 two per element, K8 one or two.  At the 2^27 transform each
// K7 pass is about 7.4 ms of IMADs against 2.6 ms of bytes, each K9 pass
// about 4.2 ms against 2.6 ms (W = 8); at W = 12 a product is 2.23 times
// the IMADs (588 against 264) and an element 1.5 times the bytes.
//
// K7 (ntt.cuh): a block keeps NL lanes of K points in shared memory, each
// thread owns 8 of them per pass and runs three radix-2 stages on them per
// barrier, on carry-chain products; it reads and writes through two TileMaps, so
// FusedNTT runs each Cooley-Tukey level through strides instead of a
// transposed copy (see ntt.cuh).  Every block reads all its elements
// before it writes any and blocks own disjoint lanes, so K7 may run in
// place (out == x, one map).  The design it replaces, two lanes per block
// on word-major rows, used 8 bytes of every 32-byte sector it loaded and
// met at a barrier after every butterfly stage: 22.7 ms per level of the
// 2^27 plan (K 512, 2^18 lanes) on an H100 at 700 W, where this one takes
// 15.9 ms, 2.14 times the IMAD bound (17.2 ms with a product at every
// butterfly past stage 0; scripts/k7_probe.py at cd1a2b6, PERF.md).
//
// K8 is one thread per element.  Its element rows (N = 1, the plan's form)
// are read and written as 16-byte words, y and z through the read-only
// path, and multiplied on carry.cuh's canonical carry chain; bound by bytes
// (3 elements moved per product at two operands).  The design it
// replaces read each word at stride N (8 bytes apart for neighbouring
// threads at N = 1) and multiplied on a word-serial product in 64-bit C.
// Word-major batches (N > 1) keep one thread per element, their words read
// at stride N.  K9 is one thread per element position:
// it reads the element's twiddle row v and column j from bit fields of
// its position (the plan's storage order), then its two factors straight
// from the small split tables (T1/T2, 8 MiB each at 2^27, L2-resident;
// each entry one element, as the data), where the TPU kernel
// needed an iota+where column pick.  K9 is
// elementwise and may run in place; its two products are K0's, as K7's
// and K8's.
#include <cuda_runtime.h>

#include <cstring>

#include "ntt.cuh"

namespace {

namespace nt = blz::ntt;

// ------------------------------------------------------------------ K7
// Blocks per SM that K7's registers must allow: as many as its shared tile
// lets in at K = 512 (72 KB at W = 8: three, at most 85 registers a
// thread; 108 KB at W = 12: two, at most 128, room for the 12-word
// butterfly without spills).
constexpr int ntt_min_blocks(int W) { return W == 8 ? 3 : 2; }

// x and o may be the same buffer (one map): no __restrict__ on them.
template <int W, int kLogK>
__global__ void __launch_bounds__(nt::kThreads, ntt_min_blocks(W))
ntt_base_kernel(const uint32_t* x, const uint32_t* __restrict__ pack, uint32_t* o,
                int64_t B, nt::TileMap in, nt::TileMap out, blz::FieldConsts<W> fc) {
  extern __shared__ uint4 ntt_smem[];
  for (int pass = 0; pass < nt::Shape<W, kLogK>::kPasses; ++pass) {
    if (pass) __syncthreads();
    nt::run_pass<W, kLogK>(pass, threadIdx.x, blockIdx.x, ntt_smem, x, pack, o, B, in, out,
                           fc);
  }
}

// ------------------------------------------------------------------ K8
constexpr int kThreads = 256;
// Elements per thread of K8's element rows: at the 2^16 plan's shape two
// were 3-6% slower and four 55-75% slower than one (scripts/k8_probe.py).
constexpr int kMulElems = 1;

// Element rows (N = 1): x, y (and z unless null), o are (M, W) elements.
// o may be x (in place); y and z are never written.
template <int W>
__global__ void __launch_bounds__(kThreads)
mul_lm_rows_kernel(const uint32_t* x, const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z, uint32_t* o, int64_t M,
                   blz::FieldConsts<W> fc) {
  const int64_t first = (int64_t)blockIdx.x * (kThreads * kMulElems) + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kMulElems; ++e) {
    const int64_t i = first + (int64_t)e * kThreads;
    if (i >= M) return;
    uint32_t a[W], b[W];
    nt::load_el<W>(a, x + i * W);
    nt::ldg_el<W>(b, y + i * W);
    blz::mont_mul_cc<W, false>(a, a, b, fc);
    if (z != nullptr) {
      nt::ldg_el<W>(b, z + i * W);
      blz::mont_mul_cc<W, false>(a, a, b, fc);
    }
    nt::store_el<W>(o + i * W, a);
  }
}

// Word-major batches (N > 1): x, y (and z unless null), o are (M, W, N);
// element (m, n) per thread.  o may be x (in place).
template <int W>
__global__ void __launch_bounds__(kThreads)
mul_lm_kernel(const uint32_t* x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, uint32_t* o, int64_t M, int64_t N,
              blz::FieldConsts<W> fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int64_t base = (i / N) * W * N + i % N;
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = x[base + w * N];
    b[w] = y[base + w * N];
  }
  blz::mont_mul_cc<W, false>(a, a, b, fc);
  if (z != nullptr) {
#pragma unroll
    for (int w = 0; w < W; ++w) b[w] = z[base + w * N];
    blz::mont_mul_cc<W, false>(a, a, b, fc);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) o[base + w * N] = a[w];
}

// ------------------------------------------------------------------ K9
// y, o: (N, W) elements; t1 (A, J, W), t2 (A, S, W) elements.  The bit
// fields of an element's position give its twiddle row v = (pos >> head)
// % A and column j = field_sum(f, pos) = jo * S + jl (ntt.cuh BitFields).
template <int W>
__global__ void __launch_bounds__(kThreads)
twiddle_mul_kernel(const uint32_t* y, const uint32_t* __restrict__ t1,
                   const uint32_t* __restrict__ t2, uint32_t* o, int64_t N, int logA,
                   int logJ, int logS, nt::BitFields f, blz::FieldConsts<W> fc) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= N) return;
  const uint32_t v = (uint32_t)(pos >> f.head) & ((1u << logA) - 1);
  const uint32_t j = (uint32_t)nt::field_sum(f, (uint64_t)pos);
  const uint32_t jo = j >> logS, jl = j & ((1u << logS) - 1);
  uint32_t a[W], b[W];
  nt::load_el<W>(a, y + pos * W);
  nt::ldg_el<W>(b, t1 + (((int64_t)v << logJ) + jo) * W);
  blz::mont_mul_cc<W, false>(a, b, a, fc);
  nt::ldg_el<W>(b, t2 + (((int64_t)v << logS) + jl) * W);
  blz::mont_mul_cc<W, false>(a, a, b, fc);
  nt::store_el<W>(o + pos * W, a);
}

// -------------------------------------------------------------- launches
template <int W, int kLogK>
int launch_ntt_base(const uint32_t* consts, const void* x, const void* pack, void* o,
                    int64_t B, const int64_t* in, const int64_t* out, cudaStream_t stream) {
  using S = nt::Shape<W, kLogK>;
  constexpr int smem = S::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_base_kernel<W, kLogK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (B + S::NL - 1) / S::NL;
  ntt_base_kernel<W, kLogK><<<(unsigned)blocks, nt::kThreads, smem, stream>>>(
      (const uint32_t*)x, (const uint32_t*)pack, (uint32_t*)o, B, nt::bit_fields(in),
      nt::bit_fields(out), blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int launch_mul_lm(const uint32_t* consts, const void* x, const void* y, const void* z,
                  void* o, int64_t M, int64_t N, cudaStream_t stream) {
  const auto fc = blz::load_consts<W>(consts);
  if (N == 1) {
    constexpr int64_t per_block = kThreads * kMulElems;
    mul_lm_rows_kernel<W><<<(unsigned)((M + per_block - 1) / per_block), kThreads, 0,
                            stream>>>((const uint32_t*)x, (const uint32_t*)y,
                                      (const uint32_t*)z, (uint32_t*)o, M, fc);
  } else {
    mul_lm_kernel<W><<<(unsigned)((M * N + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>((const uint32_t*)x, (const uint32_t*)y,
                                 (const uint32_t*)z, (uint32_t*)o, M, N, fc);
  }
  return (int)cudaGetLastError();
}

template <int W>
int launch_twiddle_mul(const uint32_t* consts, const void* y, const void* t1,
                       const void* t2, void* o, int64_t N, int logA, int logJ, int logS,
                       const int64_t* fields, cudaStream_t stream) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  twiddle_mul_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)y, (const uint32_t*)t1, (const uint32_t*)t2, (uint32_t*)o, N, logA,
      logJ, logS, nt::bit_fields(fields), blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int ntt_base_w(const uint32_t* consts, const void* x, const void* pack, void* o, int logK,
               int64_t B, const int64_t* in, const int64_t* out, cudaStream_t s) {
  switch (logK) {
    case 1: return launch_ntt_base<W, 1>(consts, x, pack, o, B, in, out, s);
    case 2: return launch_ntt_base<W, 2>(consts, x, pack, o, B, in, out, s);
    case 3: return launch_ntt_base<W, 3>(consts, x, pack, o, B, in, out, s);
    case 4: return launch_ntt_base<W, 4>(consts, x, pack, o, B, in, out, s);
    case 5: return launch_ntt_base<W, 5>(consts, x, pack, o, B, in, out, s);
    case 6: return launch_ntt_base<W, 6>(consts, x, pack, o, B, in, out, s);
    case 7: return launch_ntt_base<W, 7>(consts, x, pack, o, B, in, out, s);
    case 8: return launch_ntt_base<W, 8>(consts, x, pack, o, B, in, out, s);
    case 9: return launch_ntt_base<W, 9>(consts, x, pack, o, B, in, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every field whose 2-adicity covers logn has NTTs: the 8-word scalar
// fields (bn254_fr, bls12_377_fr, bls12_381_fr) and the 12-word
// bls12_377_fq (2-adicity 46, the scalar field of BW6-761).  So each
// kernel is built at W = 8 and W = 12; any other W is refused.  in_map /
// out_map: the TileMaps of x and o in host form (ntt.cuh BitFields: 1 + 3
// kMaxFields int64).
extern "C" int blz_ntt_base(int W, const uint32_t* consts, const void* x,
                            const void* pack, void* o, int logK, int64_t B,
                            const int64_t* in_map, const int64_t* out_map, void* stream) {
  if (B <= 0) return 0;
  auto s = (cudaStream_t)stream;
  if (W == 8) return ntt_base_w<8>(consts, x, pack, o, logK, B, in_map, out_map, s);
  if (W == 12) return ntt_base_w<12>(consts, x, pack, o, logK, B, in_map, out_map, s);
  return (int)cudaErrorInvalidValue;
}

// N = 1: element rows, every pointer 16-byte aligned (a row is 32 or 48
// bytes, so every row starts 16-byte aligned too).  o may be x.
extern "C" int blz_mul_lm(int W, const uint32_t* consts, const void* x, const void* y,
                          const void* z, void* o, int64_t M, int64_t N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto s = (cudaStream_t)stream;
  if (W == 8) return launch_mul_lm<8>(consts, x, y, z, o, M, N, s);
  if (W == 12) return launch_mul_lm<12>(consts, x, y, z, o, M, N, s);
  return (int)cudaErrorInvalidValue;
}

// fields: the row map in host form (ntt.cuh BitFields, head = v's shift).
extern "C" int blz_twiddle_mul(int W, const uint32_t* consts, const void* y,
                               const void* t1, const void* t2, void* o, int64_t N,
                               int logA, int logJ, int logS, const int64_t* fields,
                               void* stream) {
  if (N <= 0) return 0;
  auto s = (cudaStream_t)stream;
  if (W == 8) return launch_twiddle_mul<8>(consts, y, t1, t2, o, N, logA, logJ, logS, fields, s);
  if (W == 12)
    return launch_twiddle_mul<12>(consts, y, t1, t2, o, N, logA, logJ, logS, fields, s);
  return (int)cudaErrorInvalidValue;
}

// Threads that compute one lane of the named kernel as launched above, at
// either W (K7: K/8 threads per lane for K >= 8, 64 at the main path's K =
// 512; K8, K9: one thread per element), -1 for a name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  if (!strcmp(kernel, "ntt_base")) return nt::Shape<8, nt::kMaxLogK>::T;
  if (!strcmp(kernel, "mul_lm") || !strcmp(kernel, "twiddle_mul")) return 1;
  return -1;
}
