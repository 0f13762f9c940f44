// The probe bodies of E2-E5: one step x <- body(x, b) of a chain on W-word
// elements, built on the port's own device code (carry.cuh).
//
// Replaces the bodies that experiments/redc_probe.py (E2),
// vpu_mul_probe.py (E3), mul_kernel_bench.py (E4) and kernel_variants.py
// (E5) chain inside their pallas_calls.  Each body is a function of its
// input values alone; blaze_tpu_torch/experiments/chain.py holds its plain
// version on 16-bit limbs.  Every value a body computes feeds its output,
// so the compiler can drop no step of a chain (probe_chain.cu).
//
//   kMont     x <- x b / R mod p, carry.cuh mont_mul_cc<W, false> (canonical)
//   kConv     the full 2W-word product x b by mont_mul_cc's column
//             accumulation (mul_word_acc) without its REDC; x <- low ^ high
//             (the high half folded in, else it is dead code)
//   kCarry    one carry pass over the 2W limbs of x + b: x <- x + b mod R
//   kRedc     mont_mul_cc's REDC half on the 2W-word t = x + b:
//             x <- t / R mod p (canonical, for t < p R)
//   kAddF     x <- x + b mod p, carry.cuh add_canon
//   kSubF     x <- x - b mod p, carry.cuh sub_canon
//   kMulLo    per word x <- lo(x b) + b: one mul.lo (IMAD) per word
//   kMulHi    per word x <- hi(x b) + b: one mul.hi (IMAD.HI) per word
//   kMulWide  per word pair d = (x[2j+1] : x[2j]) <- lo(d) b[2j] + d: one
//             mul.wide (IMAD.WIDE) per two words
//   kConvF32  the full product x b as 8-bit digits in f32 FMAs (each column
//             an exact integer below 4W 255^2 < 2^24), carried back to words;
//             x <- low ^ high, as kConv
//   kMont11   11 independent products (x ^ i) b / R, i < 11, XOR-combined
//             (E5's "mul x11 indep")
//   kGlue15   8 add_canon and 7 sub_canon of b (E5's "addf/subf x15")
//
// Without __CUDA_ARCH__ (a host build with g++) the PTX instructions are
// emulated, so the bodies can be run on the host against the plain versions.
#pragma once

#include <cmath>

#include "carry.cuh"

namespace blz {
namespace probe {

enum Body : int {
  kMont, kConv, kCarry, kRedc, kAddF, kSubF, kMulLo, kMulHi, kMulWide, kConvF32,
  kMont11, kGlue15, kBodies
};

BLZ_DEVICE void mad_lo(uint32_t& x, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(x) : "r"(b));
#else
  x = x * b + b;
#endif
}

BLZ_DEVICE void mad_hi(uint32_t& x, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm volatile("mad.hi.u32 %0, %0, %1, %1;" : "+r"(x) : "r"(b));
#else
  x = (uint32_t)(((uint64_t)x * b) >> 32) + b;
#endif
}

BLZ_DEVICE void mad_wide(uint32_t& lo, uint32_t& hi, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint64_t d = ((uint64_t)hi << 32) | lo;
  asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(d) : "r"(lo), "r"(b));
  lo = (uint32_t)d;
  hi = (uint32_t)(d >> 32);
#else
  const uint64_t d = (uint64_t)lo * b + (((uint64_t)hi << 32) | lo);
  lo = (uint32_t)d;
  hi = (uint32_t)(d >> 32);
#endif
}

// The full product a b (2W words: lo then hi) by the rows of mont_mul_cc:
// mul_word_acc into a window of W + 2 words, one word out per row.
template <int W>
BLZ_DEVICE void conv_rows(uint32_t* lo, uint32_t* hi, const uint32_t* a, const uint32_t* b) {
  uint32_t t[W + 2], cf = 0;
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    mul_word_acc<W>(t, a, b[i], cf);
    lo[i] = t[0];
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
    t[W + 1] = 0;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) hi[j] = t[j];
}

// r = t / R mod p for the 2W + 1 words of t < p R: the reduction rows of
// mont_mul_cc (m = u[0] n0, u += m p, shift) over a window of W + 2 words
// that takes in the next word of t after each row, then one conditional
// subtraction of p that tracks the top word.
template <int W>
BLZ_DEVICE void redc_cc(uint32_t* r, const uint32_t* t, const FieldConsts<W>& fc) {
  uint32_t u[W + 2], cf = 0;
#pragma unroll
  for (int j = 0; j <= W; ++j) u[j] = t[j];
  u[W + 1] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = u[0] * fc.n0;
    mul_word_acc<W>(u, fc.p, m, cf);        // u[0] becomes 0
#pragma unroll
    for (int j = 0; j <= W; ++j) u[j] = u[j + 1];
    u[W + 1] = 0;
    add_cc(u[W], u[W], t[i + W + 1], cf);
    addc(u[W + 1], u[W + 1], 0, cf);
  }
  uint32_t s[W], hi, keep;
  sub_cc(s[0], u[0], fc.p[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(s[j], u[j], fc.p[j], cf);
  subc_cc(hi, u[W], 0, cf);
  subc(keep, 0, 0, cf);                     // all ones iff u < p
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = keep ? u[j] : s[j];
}

BLZ_DEVICE float digit_f32(const uint32_t* x, int k) {
  return (float)((x[k / 4] >> (8 * (k % 4))) & 0xFFu);
}

template <int W>
BLZ_DEVICE void conv_f32(uint32_t* x, const uint32_t* b) {
  constexpr int D = 4 * W;                  // 8-bit digits of an element
  float ad[D], col[2 * D];
#pragma unroll
  for (int k = 0; k < D; ++k) ad[k] = digit_f32(x, k);
#pragma unroll
  for (int k = 0; k < 2 * D; ++k) col[k] = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float bd = digit_f32(b, i);
#pragma unroll
    for (int j = 0; j < D; ++j) col[i + j] = fmaf(ad[j], bd, col[i + j]);
  }
  uint32_t w[2 * W];
  uint64_t c = 0;
#pragma unroll
  for (int q = 0; q < 2 * W; ++q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c += (uint64_t)(uint32_t)col[4 * q + k] << (8 * k);
    w[q] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = w[j] ^ w[W + j];
}

template <int W, int kBody>
BLZ_DEVICE void step(uint32_t* x, const uint32_t* b, const FieldConsts<W>& fc) {
  if constexpr (kBody == kMont) {
    mont_mul_cc<W, false>(x, x, b, fc);
  } else if constexpr (kBody == kConv) {
    uint32_t lo[W], hi[W];
    conv_rows<W>(lo, hi, x, b);
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = lo[j] ^ hi[j];
  } else if constexpr (kBody == kCarry) {
    uint32_t cf = 0;
    add_cc(x[0], x[0], b[0], cf);
#pragma unroll
    for (int j = 1; j < W; ++j) addc_cc(x[j], x[j], b[j], cf);
  } else if constexpr (kBody == kRedc) {
    uint32_t t[2 * W + 1], cf = 0;
    add_cc(t[0], x[0], b[0], cf);
#pragma unroll
    for (int j = 1; j < W; ++j) addc_cc(t[j], x[j], b[j], cf);
    addc(t[W], 0, 0, cf);
#pragma unroll
    for (int j = W + 1; j <= 2 * W; ++j) t[j] = 0;
    redc_cc<W>(x, t, fc);
  } else if constexpr (kBody == kAddF) {
    add_canon<W>(x, x, b, fc);
  } else if constexpr (kBody == kSubF) {
    sub_canon<W>(x, x, b, fc);
  } else if constexpr (kBody == kMulLo) {
#pragma unroll
    for (int j = 0; j < W; ++j) mad_lo(x[j], b[j]);
  } else if constexpr (kBody == kMulHi) {
#pragma unroll
    for (int j = 0; j < W; ++j) mad_hi(x[j], b[j]);
  } else if constexpr (kBody == kMulWide) {
#pragma unroll
    for (int j = 0; j < W; j += 2) mad_wide(x[j], x[j + 1], b[j]);
  } else if constexpr (kBody == kConvF32) {
    conv_f32<W>(x, b);
  } else if constexpr (kBody == kMont11) {
    uint32_t acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0;
#pragma unroll
    for (int i = 0; i < 11; ++i) {
      uint32_t y[W];
#pragma unroll
      for (int j = 0; j < W; ++j) y[j] = x[j];
      y[0] ^= (uint32_t)i;
      mont_mul_cc<W, false>(y, y, b, fc);
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] ^= y[j];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = acc[j];
  } else if constexpr (kBody == kGlue15) {
#pragma unroll
    for (int i = 0; i < 8; ++i) add_canon<W>(x, x, b, fc);
#pragma unroll
    for (int i = 0; i < 7; ++i) sub_canon<W>(x, x, b, fc);
  }
}

}  // namespace probe
}  // namespace blz
