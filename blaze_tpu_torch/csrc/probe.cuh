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
//   kMont     x <- x b / R mod p, K0's product carry.cuh mont_mul_cc<W,
//             false> (canonical; 64-bit C rows)
//   kConv     the full 2W-word product x b by mont_mul_cc's rows (mul_row)
//             without its REDC; x <- low ^ high (the high half folded in,
//             else it is dead code)
//   kCarry    one carry pass over the 2W limbs of x + b: x <- x + b mod R
//   kRedc     mont_mul_cc's REDC rows (redc_window) on the 2W-word t = x + b:
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
// Other forms of the same product, x <- x b / R mod p, each equal to kMont
// word for word (the canonical value is unique):
//   kMontHi    the lo / hi form, K0's product before the IMAD.WIDE one:
//              each word product a mad.lo.cc / madc.hi.cc pair (IMAD +
//              IMAD.HI, three FMA slots), the low and the high halves of a
//              row in two carry chains (mul_word_acc)
//   kMontRz    each word product a mul.wide.u32 (IMAD.WIDE, no addend),
//              both halves added in mul_word_acc's two chains
//   kMontComba product scanning, conv and REDC interleaved column by
//              column: every product added into a three-word column
//              accumulator (add.cc, addc.cc, addc)
//   kMontSplit kMontHi's conv rows, kMontWide's REDC rows
//   kMontWide  each word product a mad.wide.u32 whose addend is the
//              accumulator's word, the row's high halves one word up in
//              one add.cc / addc.cc chain (PTX)
//   kMontPair64 the accumulator's words as 33-bit sums T_j < 2^33 in
//              64-bit C, each word product a_j b_i + T_j
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
  kMont11, kGlue15, kMontHi, kMontRz, kMontComba, kMontSplit, kMontWide, kMontPair64,
  kBodies
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

// ------------------------------------------- the other product forms
#ifdef __CUDA_ARCH__
#define BLZ_MAD(ins, d, a, b) \
  asm volatile(ins " %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b))
#endif

// d += lo(a b) / hi(a b), with (madc) and without (mad) carry in; sets CF.
BLZ_DEVICE void mad_lo_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_MAD("mad.lo.cc.u32", d, a, b);
#else
  add_cc(d, a * b, d, cf);
#endif
}

BLZ_DEVICE void madc_lo_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_MAD("madc.lo.cc.u32", d, a, b);
#else
  addc_cc(d, a * b, d, cf);
#endif
}

BLZ_DEVICE void mad_hi_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_MAD("mad.hi.cc.u32", d, a, b);
#else
  add_cc(d, (uint32_t)(((uint64_t)a * b) >> 32), d, cf);
#endif
}

BLZ_DEVICE void madc_hi_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_MAD("madc.hi.cc.u32", d, a, b);
#else
  addc_cc(d, (uint32_t)(((uint64_t)a * b) >> 32), d, cf);
#endif
}

// (hi : lo) = a b, one mul.wide.u32 (IMAD.WIDE.U32 with no addend).
BLZ_DEVICE void mul_wide(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u64 t;\n\t"
      "mul.wide.u32 t, %2, %3;\n\t"
      "mov.b64 {%0, %1}, t;\n\t}"
      : "=r"(lo), "=r"(hi) : "r"(a), "r"(b));
#else
  const uint64_t t = (uint64_t)a * b;
  lo = (uint32_t)t;
  hi = (uint32_t)(t >> 32);
#endif
}

// t[0..W+1] += x * y (one word y), the lo / hi form's row: the low halves at words
// 0..W-1 (mad.lo.cc), the high halves at words 1..W (madc.hi.cc), carries
// into t[W] and t[W+1].
template <int W>
BLZ_DEVICE void mul_word_acc(uint32_t* t, const uint32_t* x, uint32_t y, uint32_t& cf) {
  mad_lo_cc(t[0], x[0], y, cf);
#pragma unroll
  for (int j = 1; j < W; ++j) madc_lo_cc(t[j], x[j], y, cf);
  addc_cc(t[W], t[W], 0, cf);
  addc(t[W + 1], t[W + 1], 0, cf);
  mad_hi_cc(t[1], x[0], y, cf);
#pragma unroll
  for (int j = 1; j < W; ++j) madc_hi_cc(t[j + 1], x[j], y, cf);
  addc(t[W + 1], t[W + 1], 0, cf);
}

// mul_word_acc's row with each word product one mul.wide.u32.
template <int W>
BLZ_DEVICE void mul_word_acc_rz(uint32_t* t, const uint32_t* x, uint32_t y, uint32_t& cf) {
  uint32_t lo[W], hi[W];
#pragma unroll
  for (int j = 0; j < W; ++j) mul_wide(lo[j], hi[j], x[j], y);
  add_cc(t[0], t[0], lo[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(t[j], t[j], lo[j], cf);
  addc_cc(t[W], t[W], 0, cf);
  addc(t[W + 1], t[W + 1], 0, cf);
  add_cc(t[1], t[1], hi[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(t[j + 1], t[j + 1], hi[j], cf);
  addc(t[W + 1], t[W + 1], 0, cf);
}

// (hi : lo) = a b + c, one mad.wide.u32 (IMAD.WIDE.U32) with the word c as
// its 64-bit addend (a b + c <= 2^64 - 2^32, so exact).  Touches no flag.
BLZ_DEVICE void mad_wide(uint32_t& lo, uint32_t& hi, uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u64 t;\n\t"
      "cvt.u64.u32 t, %4;\n\t"
      "mad.wide.u32 t, %2, %3, t;\n\t"
      "mov.b64 {%0, %1}, t;\n\t}"
      : "=r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(c));
#else
  const uint64_t t = (uint64_t)a * b + c;
  lo = (uint32_t)t;
  hi = (uint32_t)(t >> 32);
#endif
}

// t[0..W+1] += x y (one word y): one row of the product.  Word j's product
// takes t[j] as its addend; the high halves go one word up in one carry
// chain that ends in t[W] and t[W+1].  The caller keeps the sum below
// 2^(32(W+2)).
template <int W>
BLZ_DEVICE void wide_row(uint32_t* t, const uint32_t* x, uint32_t y, uint32_t& cf) {
  uint32_t lo, hi, up;
  mad_wide(t[0], up, x[0], y, t[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) {
    mad_wide(lo, hi, x[j], y, t[j]);
    if (j == 1) add_cc(t[j], lo, up, cf);
    else addc_cc(t[j], lo, up, cf);
    up = hi;
  }
  addc_cc(t[W], t[W], up, cf);
  addc(t[W + 1], t[W + 1], 0, cf);
}

// t <- (t + m p) / 2^32 over the W+2 words of t, m = t[0] n0: one row of
// the REDC.  The low word of t + m p is 0 (so only the first product's
// high half is kept), the products are wide_row's, and t[W+1] becomes 0.
template <int W>
BLZ_DEVICE void wide_redc_row(uint32_t* t, const FieldConsts<W>& fc, uint32_t& cf) {
  const uint32_t m = t[0] * fc.n0;
  uint32_t lo, hi, up;
  mad_wide(lo, up, fc.p[0], m, t[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) {
    mad_wide(lo, hi, fc.p[j], m, t[j]);
    if (j == 1) add_cc(t[j - 1], lo, up, cf);
    else addc_cc(t[j - 1], lo, up, cf);
    up = hi;
  }
  addc_cc(t[W - 1], t[W], up, cf);
  addc(t[W], t[W + 1], 0, cf);
  t[W + 1] = 0;
}

// The CIOS on wide_row and wide_redc_row, canonical.
template <int W>
BLZ_DEVICE void mont_wide(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const FieldConsts<W>& fc) {
  uint32_t t[W + 2], cf = 0;
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    wide_row<W>(t, a, b[i], cf);
    wide_redc_row<W>(t, fc, cf);
  }
  canon_sub<W>(r, t, fc);
}

// The word-serial CIOS on the row `kRow` (0 mul_word_acc, 1
// mul_word_acc_rz) for both halves, or (kRow 2) mul_word_acc's conv rows
// and wide_redc_row's REDC rows: the same (T + m p) / R as mont_mul_cc, lazy
// (< 2p for a, b < 2p, R > 4p) or canonical.  r may alias a or b.
template <int W, int kRow, bool kLazy = false>
BLZ_DEVICE void mont_rows(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const FieldConsts<W>& fc) {
  uint32_t t[W + 2], cf = 0;
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (kRow == 1) mul_word_acc_rz<W>(t, a, b[i], cf);
    else mul_word_acc<W>(t, a, b[i], cf);
    if (kRow == 2) {
      wide_redc_row<W>(t, fc, cf);
      continue;
    }
    const uint32_t m = t[0] * fc.n0;
    if (kRow == 1) mul_word_acc_rz<W>(t, fc.p, m, cf);   // t[0] becomes 0
    else mul_word_acc<W>(t, fc.p, m, cf);
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
    t[W + 1] = 0;
  }
  if (kLazy) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = t[j];
  } else {
    canon_sub<W>(r, t, fc);
  }
}

// (c2 : c1 : c0) += x y, one mul.wide.u32 and a three-link carry chain.
BLZ_DEVICE void col_acc(uint32_t& c0, uint32_t& c1, uint32_t& c2, uint32_t x, uint32_t y,
                        uint32_t& cf) {
  uint32_t lo, hi;
  mul_wide(lo, hi, x, y);
  add_cc(c0, c0, lo, cf);
  addc_cc(c1, c1, hi, cf);
  addc(c2, c2, 0, cf);
}

// Product scanning: column k of a b and of m p summed in (c2 : c1 : c0);
// for k < W the digit m_k = c0 n0 clears the column's low word, past it
// the low word is the result's word k - W.  The same (T + m p) / R as
// mont_mul_cc (the m_k are its digits), canonical.  r may alias a or b.
template <int W>
BLZ_DEVICE void mont_comba(uint32_t* r, const uint32_t* a, const uint32_t* b,
                           const FieldConsts<W>& fc) {
  uint32_t m[W], u[W + 1], c0 = 0, c1 = 0, c2 = 0, cf = 0;
#pragma unroll
  for (int k = 0; k < 2 * W - 1; ++k) {
#pragma unroll
    for (int i = (k < W ? 0 : k - W + 1); i <= (k < W ? k : W - 1); ++i)
      col_acc(c0, c1, c2, a[i], b[k - i], cf);
#pragma unroll
    for (int i = (k < W ? 0 : k - W + 1); i < (k < W ? k : W); ++i)
      col_acc(c0, c1, c2, m[i], fc.p[k - i], cf);
    if (k < W) {
      m[k] = c0 * fc.n0;
      col_acc(c0, c1, c2, m[k], fc.p[0], cf);      // c0 becomes 0
    } else {
      u[k - W] = c0;
    }
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  u[W - 1] = c0;
  u[W] = c1;
  canon_sub<W>(r, u, fc);
}

// The CIOS on a redundant accumulator, in 64-bit C: word j of t is T_j <
// 2^33.  A conv row makes P_j = a_j b_i + T_j (a b + T < 2^64) and T_j <-
// lo(P_j) + hi(P_j-1); a REDC row, m = T_0 n0, makes Q_j = p_j m + T_j and
// T_j-1 <- lo(Q_j) + hi(Q_j-1) (lo(Q_0) = 0), the top T_W-1 <- hi(P_W-1) +
// hi(Q_W-1).  At the end one carry pass gives W+1 words.
template <int W>
BLZ_DEVICE void mont_pair64(uint32_t* r, const uint32_t* a, const uint32_t* b,
                            const FieldConsts<W>& fc) {
  uint64_t T[W];
#pragma unroll
  for (int j = 0; j < W; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t P[W];
#pragma unroll
    for (int j = 0; j < W; ++j) P[j] = (uint64_t)a[j] * b[i] + T[j];
    T[0] = (uint32_t)P[0];
#pragma unroll
    for (int j = 1; j < W; ++j) T[j] = (uint64_t)(uint32_t)P[j] + (P[j - 1] >> 32);
    const uint32_t top = (uint32_t)(P[W - 1] >> 32);
    const uint32_t m = (uint32_t)T[0] * fc.n0;
#pragma unroll
    for (int j = 0; j < W; ++j) P[j] = (uint64_t)fc.p[j] * m + T[j];
#pragma unroll
    for (int j = 1; j < W; ++j) T[j - 1] = (uint64_t)(uint32_t)P[j] + (P[j - 1] >> 32);
    T[W - 1] = (uint64_t)top + (P[W - 1] >> 32);
  }
  uint32_t u[W + 1];
  uint64_t c = T[0];
  u[0] = (uint32_t)c;
#pragma unroll
  for (int j = 1; j < W; ++j) {
    c = (c >> 32) + T[j];
    u[j] = (uint32_t)c;
  }
  u[W] = (uint32_t)(c >> 32);
  canon_sub<W>(r, u, fc);
}

// ---------------------------------------------------- the product's parts
// The full product a b (2W words: lo then hi) by mont_mul_cc's rows:
// mul_row into a window of W + 2 words, one word out per row.
template <int W>
BLZ_DEVICE void conv_rows(uint32_t* lo, uint32_t* hi, const uint32_t* a, const uint32_t* b) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    mul_row<W>(t, a, b[i]);
    lo[i] = t[0];
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
    t[W + 1] = 0;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) hi[j] = t[j];
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
    uint32_t t[2 * W + 1], u[W + 2], cf = 0;
    add_cc(t[0], x[0], b[0], cf);
#pragma unroll
    for (int j = 1; j < W; ++j) addc_cc(t[j], x[j], b[j], cf);
    addc(t[W], 0, 0, cf);
#pragma unroll
    for (int j = W + 1; j <= 2 * W; ++j) t[j] = 0;
    redc_window<W>(u, t, fc);
    canon_sub<W>(x, u, fc);
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
  } else if constexpr (kBody == kMontHi) {
    mont_rows<W, 0>(x, x, b, fc);
  } else if constexpr (kBody == kMontRz) {
    mont_rows<W, 1>(x, x, b, fc);
  } else if constexpr (kBody == kMontComba) {
    mont_comba<W>(x, x, b, fc);
  } else if constexpr (kBody == kMontSplit) {
    mont_rows<W, 2>(x, x, b, fc);
  } else if constexpr (kBody == kMontWide) {
    mont_wide<W>(x, x, b, fc);
  } else if constexpr (kBody == kMontPair64) {
    mont_pair64<W>(x, x, b, fc);
  }
}

}  // namespace probe
}  // namespace blz
