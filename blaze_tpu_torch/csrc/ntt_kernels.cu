// K7-K9: the NTT's kernels, lanes-major (rows x W words x lanes), canonical.
//
// A batch of B independent values per row is (R, W, B) words: word w of
// (row r, lane b) at (r * W + w) * B + b, so neighbouring threads (lanes)
// touch neighbouring words and a warp's loads and stores coalesce.  Every
// value stays canonical (< p): the scalar fields have R < 4p, so the lazy
// < 2p discipline of the EC kernels is unsound here (kLazy = false).
//
// Replaces (blaze_tpu/ntt/kernels.py, NTTKernels):
//   K7 blz_ntt_base    <- _ntt_fn / ntt_base      (whole K-point DIT NTT per lane)
//   K8 blz_mul_lm      <- _mul_fn / mul_lm        (elementwise x*y[*z])
//   K9 blz_twiddle_mul <- _twmul_fn / twiddle_mul (y * T1[v, jo] * T2[v, jl])
//
// Bound on the H100: integer multiply-adds.  A W-word product is 4W^2 + W
// IMADs; K7 does (K/2)(log2 K - 1) products per K points (stage 0 has no
// twiddle), K9 two per element, K8 one or two.  At the 2^27 transform each
// K7 pass is about 8.5 ms of IMADs against 2.6 ms of bytes, each K9 pass
// about 4.2 ms against 2.6 ms.
//
// Design.  K7 keeps one block's transforms whole in shared memory across
// all log2 K stages (the TPU kernel kept them in VMEM), kLanes lanes per
// block, one butterfly per thread at a time and __syncthreads() between
// stages; the bit-reversal gather the JAX package did outside the kernel is
// folded into K7's loads (row rev(k) is read into position k).  Every block
// reads all its lanes before it writes any, and blocks own disjoint lanes,
// so K7 may run in place (out == x).  K8 and K9 are one thread per element;
// K9 reads its two factors straight from the small split tables (T1/T2,
// 8 MiB each at 2^27, L2-resident), where the TPU kernel needed an
// iota+where column pick.  K9 is elementwise and may run in place.
#include <cuda_runtime.h>

#include <cstring>

#include "field.cuh"

namespace {

// ------------------------------------------------------------------ K7
// Shared layout of one block: element (k, word w, lane t) at
// k * kRow + w * kLanes + t.  A warp covers kLanes lanes of 32 / kLanes
// butterflies; the kPad words per row put the rows of neighbouring
// butterflies on different banks (conflict-free from stage 4 on, 2-way
// before).  Two lanes and 128 threads per block: 37 KB of shared memory at
// K = 512, so several blocks share an SM and one block's loads overlap
// another's butterflies.
constexpr int kLanes = 2;
constexpr int kPad = 2;
constexpr int kNttThreads = 128;
constexpr int kMaxLogK = 9;

template <int W>
constexpr int kRowWords = W * kLanes + kPad;

// the largest tile fits the default 48 KB of dynamic shared memory
static_assert((1 << kMaxLogK) * kRowWords<8> * 4 <= 48 * 1024, "K7 tile too large");

template <int W>
__global__ void __launch_bounds__(kNttThreads)
ntt_base_kernel(const uint32_t* x, const uint32_t* __restrict__ pack, uint32_t* o,
                int logK, int64_t B, blz::FieldConsts<W> fc) {
  extern __shared__ uint32_t sm[];
  constexpr int kRow = kRowWords<W>;
  const int K = 1 << logK;
  const int64_t b0 = (int64_t)blockIdx.x * kLanes;
  const int total = K * W * kLanes;

  // load, bit-reversing the rows: position k <- row rev(k)
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int t = i % kLanes;
    const int w = (i / kLanes) % W;
    const int k = i / (kLanes * W);
    const int64_t lane = b0 + t;
    if (lane < B) {
      const int src = (int)(__brev((unsigned)k) >> (32 - logK));
      sm[k * kRow + w * kLanes + t] = x[((int64_t)src * W + w) * B + lane];
    }
  }
  __syncthreads();

  const int t = threadIdx.x % kLanes;
  const bool live = b0 + t < B;
  const int jstep = blockDim.x / kLanes;
  for (int s = 0; s < logK; ++s) {
    const int m = 1 << s;
    if (live) {
      for (int j = threadIdx.x / kLanes; j < K / 2; j += jstep) {
        const int pos = j & (m - 1);
        const int ia = ((j >> s) << (s + 1)) | pos;
        uint32_t* ea = sm + ia * kRow + t;
        uint32_t* eb = ea + m * kRow;
        uint32_t u[W], v[W], lo[W], hi[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          u[w] = ea[w * kLanes];
          v[w] = eb[w * kLanes];
        }
        if (s > 0) {                       // stage 0's twiddle is W^0 = 1
          uint32_t tw[W];
          const uint32_t* tp = pack + (int64_t)(m - 1 + pos) * W;
#pragma unroll
          for (int w = 0; w < W; ++w) tw[w] = __ldg(tp + w);
          blz::mont_mul<W, false>(v, tw, v, fc);
        }
        blz::fadd<W, false>(lo, u, v, fc);
        blz::fsub<W, false>(hi, u, v, fc);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          ea[w * kLanes] = lo[w];
          eb[w * kLanes] = hi[w];
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int tt = i % kLanes;
    const int w = (i / kLanes) % W;
    const int k = i / (kLanes * W);
    const int64_t lane = b0 + tt;
    if (lane < B) o[((int64_t)k * W + w) * B + lane] = sm[k * kRow + w * kLanes + tt];
  }
}

// ------------------------------------------------------------------ K8
constexpr int kThreads = 256;

// x, y (and z unless null), o: (M, W, N); element (m, n) per thread.
template <int W>
__global__ void __launch_bounds__(kThreads)
mul_lm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, uint32_t* __restrict__ o, int64_t M,
              int64_t N, blz::FieldConsts<W> fc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int64_t base = (i / N) * W * N + i % N;
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = x[base + w * N];
    b[w] = y[base + w * N];
  }
  blz::mont_mul<W, false>(a, a, b, fc);
  if (z != nullptr) {
#pragma unroll
    for (int w = 0; w < W; ++w) b[w] = z[base + w * N];
    blz::mont_mul<W, false>(a, a, b, fc);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) o[base + w * N] = a[w];
}

// ------------------------------------------------------------------ K9
// y, o: (A, W, J*S*B), lane l = (jo*S + jl)*B + b; t1 (A, W, J), t2 (A, W, S).
// Grid: x over lanes, y over rows v.
template <int W>
__global__ void __launch_bounds__(kThreads)
twiddle_mul_kernel(const uint32_t* y, const uint32_t* __restrict__ t1,
                   const uint32_t* __restrict__ t2, uint32_t* o, int J, int S,
                   int B, blz::FieldConsts<W> fc) {
  const int64_t lanes = (int64_t)J * S * B;
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int64_t v = blockIdx.y;
  const int j = (int)(l / B);
  const int jo = j / S, jl = j % S;
  const uint32_t* yp = y + v * W * lanes + l;
  const uint32_t* p1 = t1 + v * W * J + jo;
  const uint32_t* p2 = t2 + v * W * S + jl;
  uint32_t a[W], f[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = yp[w * lanes];
    f[w] = __ldg(p1 + (int64_t)w * J);
  }
  blz::mont_mul<W, false>(a, f, a, fc);
#pragma unroll
  for (int w = 0; w < W; ++w) f[w] = __ldg(p2 + (int64_t)w * S);
  blz::mont_mul<W, false>(a, a, f, fc);
  uint32_t* op = o + v * W * lanes + l;
#pragma unroll
  for (int w = 0; w < W; ++w) op[w * lanes] = a[w];
}

// -------------------------------------------------------------- launches
template <int W>
int launch_ntt_base(const uint32_t* consts, const void* x, const void* pack, void* o,
                    int logK, int64_t B, cudaStream_t stream) {
  const size_t smem = (size_t)(1 << logK) * kRowWords<W> * sizeof(uint32_t);
  const int64_t blocks = (B + kLanes - 1) / kLanes;
  ntt_base_kernel<W><<<(unsigned)blocks, kNttThreads, smem, stream>>>(
      (const uint32_t*)x, (const uint32_t*)pack, (uint32_t*)o, logK, B,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int launch_mul_lm(const uint32_t* consts, const void* x, const void* y, const void* z,
                  void* o, int64_t M, int64_t N, cudaStream_t stream) {
  const int64_t blocks = (M * N + kThreads - 1) / kThreads;
  mul_lm_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)o, M, N,
      blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

template <int W>
int launch_twiddle_mul(const uint32_t* consts, const void* y, const void* t1,
                       const void* t2, void* o, int A, int J, int S, int B,
                       cudaStream_t stream) {
  const int64_t lanes = (int64_t)J * S * B;
  const dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads), (unsigned)A);
  twiddle_mul_kernel<W><<<grid, kThreads, 0, stream>>>(
      (const uint32_t*)y, (const uint32_t*)t1, (const uint32_t*)t2, (uint32_t*)o, J, S,
      B, blz::load_consts<W>(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// Only the 8-word scalar fields (bn254_fr, bls12_377_fr, bls12_381_fr) have
// NTTs; any other W is refused.
extern "C" int blz_ntt_base(int W, const uint32_t* consts, const void* x,
                            const void* pack, void* o, int logK, int64_t B,
                            void* stream) {
  if (B <= 0) return 0;
  if (W != 8 || logK < 1 || logK > kMaxLogK) return (int)cudaErrorInvalidValue;
  return launch_ntt_base<8>(consts, x, pack, o, logK, B, (cudaStream_t)stream);
}

extern "C" int blz_mul_lm(int W, const uint32_t* consts, const void* x, const void* y,
                          const void* z, void* o, int64_t M, int64_t N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (W != 8) return (int)cudaErrorInvalidValue;
  return launch_mul_lm<8>(consts, x, y, z, o, M, N, (cudaStream_t)stream);
}

extern "C" int blz_twiddle_mul(int W, const uint32_t* consts, const void* y,
                               const void* t1, const void* t2, void* o, int A, int J,
                               int S, int B, void* stream) {
  if (A <= 0 || J <= 0 || S <= 0 || B <= 0) return 0;
  if (W != 8 || A > 65535) return (int)cudaErrorInvalidValue;
  return launch_twiddle_mul<8>(consts, y, t1, t2, o, A, J, S, B, (cudaStream_t)stream);
}

// Threads that compute one lane of the named kernel as launched above (K7:
// a block of kNttThreads threads over kLanes lanes; K8, K9: one thread per
// element), -1 for a name not in this library.
extern "C" int blz_threads_per_lane(const char* kernel) {
  if (!strcmp(kernel, "ntt_base")) return kNttThreads / kLanes;
  if (!strcmp(kernel, "mul_lm") || !strcmp(kernel, "twiddle_mul")) return 1;
  return -1;
}
