// E1: the canonical Montgomery product with its REDC on the int8 tensor
// cores, and E2's mm_i8 / qmm_i8 bodies (those two matrix products alone).
//
// Replaces experiments/pallas_mul.py:146 PallasMont.mul (body _kernel :77):
// the limb convolution on the TPU's VPU, then REDC as two bf16 matrix
// products of byte-split operands on its matrix unit; and the mm_i8 /
// qmm_i8 bodies of experiments/redc_probe.py (:91, :99), which chain the
// two int8 products of the REDC alone.
//
// The product r = a b / R mod p (R = 2^(32W)), canonical for a, b < p:
//   1. t = a b, 2W words, on IMAD (carry.cuh mul_acc_cc), one element per
//      thread;
//   2. m = t n' mod R (n' = -p^-1 mod R) as N . bytes(t mod R): N is the
//      constant lower-triangular byte Toeplitz matrix of n' (4W x 4W,
//      N[k][j] = byte k-j of n'), so column k of the product is
//      sum_j n'_(k-j) t_j, and m = sum_k col_k 2^(8k) mod R;
//   3. q = m p as P . bytes(m): P (8W x 4W, P[k][j] = byte k-j of p);
//   4. u = (t + q) / R < 2p, one conditional subtraction of p.
// Steps 2 and 3 run on mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32: the
// constant matrix is the A operand (16 rows x 32 bytes per tile, its
// fragments made on the host, experiments/chain.py tc_fragments), the
// bytes of 8 elements the B operand (32 bytes x 8 columns), and every
// column sum is below 4W 255^2 < 2^23, so the s32 sums are exact.  The sums
// are carried into words with 64-bit adds, one element per thread.
//
// Design: one warp per 32 elements, four groups of 8 per matrix product;
// each thread holds its element's words and t in registers, the warp's
// B operand words and D column sums go through shared memory (odd row
// strides: a thread's carry pass reads its row with no bank conflict).  It
// is the simple form (mma.sync from registers, A fragments read through L1);
// wgmma and TMA are later work.  Bound: the IMADs of step 1 (2W^2), the
// tensor-core products (W = 8: 6 tiles, W = 12: 14 non-zero tiles per 8
// elements), and the carries and shared-memory round trips between them.
//
// Modes: kMont (E1, chained M times: x <- x b / R mod p), kMm (x <- x n' mod
// R), kQmm (x <- floor(x p / R)).  Needs sm_80 or later for the u8
// mma.sync; the library is built for sm_90a only.
#include <cuda_runtime.h>

#include <cstring>

#include "carry.cuh"

namespace {

enum Mode : int { kMont, kMm, kQmm };

constexpr int kWarps = 2;          // warps per block

template <int W>
struct Tc {
  static constexpr int KT = (4 * W + 31) / 32;   // 32-byte k tiles of an element
  static constexpr int RM = 4 * W / 16;          // 16-row tiles of N (m's columns)
  static constexpr int RQ = 8 * W / 16;          // 16-row tiles of P (q's columns)
  static constexpr int XS = W + 1;               // words per element row in smem
  static constexpr int CS = 8 * W + 1;           // column sums per element row
  static constexpr int kSmemWords = 32 * XS + 32 * CS;

  // Tile (r, c) of N or P holds a non-zero entry: N[k][j] != 0 needs
  // 0 <= k - j, P[k][j] needs 0 <= k - j < 4W, with j < 4W.
  __host__ __device__ static constexpr bool nz_n(int r, int c) { return 32 * c <= 16 * r + 15; }
  __host__ __device__ static constexpr bool nz_p(int r, int c) {
    return 32 * c <= 16 * r + 15 && 16 * r - (32 * c + 31 < 4 * W - 1 ? 32 * c + 31 : 4 * W - 1) < 4 * W;
  }
};

__device__ __forceinline__ void mma_u8(int* d, const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// cols[e][16 r + i] = sum_j A[16 r + i][j] byte_j(xs[e]) for the warp's 32
// elements e, A = N (kP false, R tiles RM) or P (kP true, RQ): tile (r, c)'s
// fragments at frags[(r KT + c) 32 + lane].  Fragment layouts of
// m16n8k32 (PTX ISA), g = lane / 4, t = lane % 4: B register 0 holds bytes
// 4t..4t+3 of column g, register 1 bytes 16+4t..16+4t+3, so a k tile's
// two registers are words 8c + t and 8c + 4 + t of element g; D register
// i holds row g + 8 (i / 2), column 2t + (i % 2).
template <int W, bool kP>
__device__ __forceinline__ void tc_product(const uint4* __restrict__ frags,
                                           const uint32_t* xs, uint32_t* cols, int lane) {
  using T = Tc<W>;
  constexpr int R = kP ? T::RQ : T::RM;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    const uint32_t* xe = xs + (8 * grp + g) * T::XS;
    uint32_t bf[T::KT][2];
#pragma unroll
    for (int c = 0; c < T::KT; ++c) {
      bf[c][0] = 8 * c + t < W ? xe[8 * c + t] : 0;
      bf[c][1] = 8 * c + 4 + t < W ? xe[8 * c + 4 + t] : 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int d[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < T::KT; ++c) {
        if (kP ? T::nz_p(r, c) : T::nz_n(r, c))
          mma_u8(d, __ldg(frags + (r * T::KT + c) * 32 + lane), bf[c][0], bf[c][1]);
      }
      uint32_t* e0 = cols + (8 * grp + 2 * t) * T::CS + 16 * r + g;
      e0[0] = d[0];
      e0[T::CS] = d[1];
      e0[8] = d[2];
      e0[T::CS + 8] = d[3];
    }
  }
}

// Word w of sum_k col_k 2^(8k) before carries: col_4w .. col_4w+3 shifted.
__device__ __forceinline__ uint64_t col_word(const uint32_t* col, int w) {
  return (uint64_t)col[4 * w] + ((uint64_t)col[4 * w + 1] << 8) +
         ((uint64_t)col[4 * w + 2] << 16) + ((uint64_t)col[4 * w + 3] << 24);
}

template <int W, int kMode>
__global__ void __launch_bounds__(32 * kWarps)
mont_tc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ o, int64_t N, int M, const uint4* __restrict__ frag_n,
               const uint4* __restrict__ frag_p, blz::FieldConsts<W> fc) {
  using T = Tc<W>;
  __shared__ uint32_t smem[kWarps][T::kSmemWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* xs = smem[warp] + lane * T::XS;            // this thread's element row
  uint32_t* xw = smem[warp];                           // the warp's rows
  uint32_t* cw = smem[warp] + 32 * T::XS;              // the warp's column sums
  const uint32_t* col = cw + lane * T::CS;
  const int64_t e = ((int64_t)blockIdx.x * kWarps + warp) * 32 + lane;
  const bool live = e < N;
  uint32_t x[W], y[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x[w] = live ? a[e * W + w] : 0;
    y[w] = live && kMode == kMont ? b[e * W + w] : 0;
  }
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    uint32_t t[2 * W + 1];
#pragma unroll
    for (int j = 0; j <= 2 * W; ++j) t[j] = 0;
    if (kMode == kMont) blz::mul_acc_cc<W>(t, x, y);
#pragma unroll
    for (int w = 0; w < W; ++w) xs[w] = kMode == kMont ? t[w] : x[w];
    __syncwarp();
    if (kMode != kQmm) {
      tc_product<W, false>(frag_n, xw, cw, lane);
      __syncwarp();
      uint64_t c = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        c += col_word(col, w);
        x[w] = (uint32_t)c;                           // m = t n' mod R
        c >>= 32;
      }
      __syncwarp();
      if (kMode == kMm) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) xs[w] = x[w];
      __syncwarp();
    }
    tc_product<W, true>(frag_p, xw, cw, lane);
    __syncwarp();
    uint32_t u[W + 1];
    uint64_t c = 0;
#pragma unroll
    for (int w = 0; w < 2 * W; ++w) {
      c += (uint64_t)t[w] + col_word(col, w);
      if (w >= W) u[w - W] = (uint32_t)c;
      c >>= 32;
    }
    u[W] = (uint32_t)c;
    __syncwarp();
    if (kMode == kQmm) {
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = u[w];        // floor(x p / R) < p
    } else {
      uint32_t s[W], hi, keep, cf = 0;
      blz::sub_cc(s[0], u[0], fc.p[0], cf);
#pragma unroll
      for (int j = 1; j < W; ++j) blz::subc_cc(s[j], u[j], fc.p[j], cf);
      blz::subc_cc(hi, u[W], 0, cf);
      blz::subc(keep, 0, 0, cf);                      // all ones iff u < p
#pragma unroll
      for (int j = 0; j < W; ++j) x[j] = keep ? u[j] : s[j];
    }
  }
  if (live) {
#pragma unroll
    for (int w = 0; w < W; ++w) o[e * W + w] = x[w];
  }
}

template <int W, int kMode>
int launch(const uint32_t* consts, const void* frags, const void* a, const void* b, void* o,
           int64_t N, int M, cudaStream_t s) {
  using T = Tc<W>;
  const auto fn = (const uint4*)frags;
  const int64_t blocks = (N + 32 * kWarps - 1) / (32 * kWarps);
  mont_tc_kernel<W, kMode><<<(unsigned)blocks, 32 * kWarps, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)o, N, M, fn,
      fn + T::RM * T::KT * 32, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int launch_w(int mode, const uint32_t* consts, const void* frags, const void* a, const void* b,
             void* o, int64_t N, int M, cudaStream_t s) {
  switch (mode) {
    case kMont: return launch<W, kMont>(consts, frags, a, b, o, N, M, s);
    case kMm: return launch<W, kMm>(consts, frags, a, b, o, N, M, s);
    case kQmm: return launch<W, kQmm>(consts, frags, a, b, o, N, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// frags: the A fragments of N's RM x KT tiles, then P's RQ x KT tiles,
// each 32 lanes x 4 words (experiments/chain.py tc_fragments).  b is read
// in kMont only.  Launches on `stream`; returns cudaGetLastError().
extern "C" int blz_mont_tc(int W, int mode, const uint32_t* consts, const void* frags,
                           const void* a, const void* b, void* o, int64_t N, int M,
                           void* stream) {
  if (N <= 0) return 0;
  auto s = (cudaStream_t)stream;
  switch (W) {
    case 8: return launch_w<8>(mode, consts, frags, a, b, o, N, M, s);
    case 12: return launch_w<12>(mode, consts, frags, a, b, o, N, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int blz_threads_per_lane(const char* kernel) {
  return strcmp(kernel, "mont_tc") ? -1 : 1;
}
