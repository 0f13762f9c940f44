// K0: the Montgomery product and REDC of every kernel, and the PTX carry
// chains of its adds and subs, for Hopper (sm_90a).
//
// One copy of the carry-chain primitives and the one Montgomery product
// and REDC, shared by K1 (montmul.cu), K2-K6 (ec_team.cuh,
// lazy products), K7-K9 (ntt.cuh, ntt_kernels.cu, canonical products,
// adds and subs), K10 (poseidon.cuh, canonical products and unreduced
// sums), KF (field_ew.cuh, adds and subs) and E1-E5 (mont_tc.cu, probe.cuh).
//
// What bounds the product on an H100: the FMA pipe's slots and, in
// kernels with few warps per SM, one product's latency.  Per SM and clock
// the card issues 64 lanes of FMA-pipe slots (IMAD, IMAD.X, IMAD.MOV take
// one, IMAD.HI and IMAD.WIDE two), 64 of ALU-pipe operations (IADD3 with
// or without carries, LOP3, SEL, ISETP) and 128 of instructions.  The rows
// are 64-bit C, c = x_j y + t_j + c per word, which ptxas makes into one
// IMAD.WIDE.U32 whose 64-bit addend is the register pair t_j + hi(c)
// (IADD3, then IADD3.X or IMAD.X for its top bit): 744 FMA slots and 526
// ALU operations per W = 12 product, 332 and 262 at W = 8 (SASS of the E2
// body mont), against 909 and 629 for the lo / hi form it replaced
// (mad.lo.cc / madc.hi.cc pairs, IMAD + IMAD.HI; probe.cuh keeps it as
// mont_hi).  Why this form and not one with fewer slots or a higher
// chained rate: on the card (PERF.md, E2's forms and scripts/kernel_ab.py)
// a PTX form with the carries in add.cc chains (probe.cuh mont_wide) chains
// 1% faster but has 45% more latency at W = 12, and K2, K4, K7, K9 and K10
// ran 6-13% slower on it than on these rows.  The floor 4W^2 + W (588 at W = 12,
// bench/profile.py product_imads) counts each word product as one
// IMAD.WIDE and nothing else.
//
// Why no sum is lost: c = x_j y + t_j + c <= (2^32 - 1)^2 + 2 (2^32 - 1) =
// 2^64 - 1, so a word product with two word addends fits 64 bits.
//
// Exactness is by value.  mont_mul_cc is the word-serial CIOS: row i adds
// a b[i], then m_i = t[0] n0 (n0 = -p^-1 mod 2^32) and m_i p, which clears
// the low word, and shifts one word down.  The digits m_i form the unique
// m = T (-p^-1) mod R (R = 2^(32W), T = a b), so the result is exactly
// (T + m p) / R, the JAX package's full-width REDC bit for bit.  Lazy:
// that value, < 2p for a, b < 2p (R > 4p), no final subtraction, equal to
// the JAX kernels' lazy limbs.  Canonical: < p for a, b < p, by one
// conditional subtraction of p that tracks the top word.  redc_sum runs
// the same REDC rows over a 2W+1-word sum T of up to t unreduced products
// (mul_acc_cc): (T + m p) / R < (subs + 1) p, brought under p by
// conditional subtractions of the multiples 2^b p (fields/kernel_ops.py
// reduce_multiples); the output is canonical, hence unique.
//
// cf is the carry (borrow for sub) flag of the host emulation: without
// __CUDA_ARCH__ (a host build with g++) every instruction is emulated with
// it, so the device code can be run on the host against the plain
// versions.  On the device it is the hardware CC.CF and the argument is
// unused; the carry asm statements are volatile, so the compiler keeps
// each chain in order.
#pragma once

#include "field.cuh"

#ifndef __CUDACC__
struct uint4 {
  uint32_t x, y, z, w;
};
#endif

namespace blz {

#ifdef __CUDA_ARCH__
#define BLZ_CC(ins, d, a, b) \
  asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#endif

BLZ_DEVICE void add_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("add.cc.u32", d, a, b);
#else
  const uint64_t s = (uint64_t)a + b;
  d = (uint32_t)s;
  cf = (uint32_t)(s >> 32);
#endif
}

BLZ_DEVICE void addc_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("addc.cc.u32", d, a, b);
#else
  const uint64_t s = (uint64_t)a + b + cf;
  d = (uint32_t)s;
  cf = (uint32_t)(s >> 32);
#endif
}

BLZ_DEVICE void addc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("addc.u32", d, a, b);
#else
  d = a + b + cf;
#endif
}

BLZ_DEVICE void sub_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("sub.cc.u32", d, a, b);
#else
  d = a - b;
  cf = a < b;
#endif
}

BLZ_DEVICE void subc_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("subc.cc.u32", d, a, b);
#else
  const uint64_t s = (uint64_t)a - b - cf;
  d = (uint32_t)s;
  cf = (uint32_t)(s >> 63);
#endif
}

BLZ_DEVICE void subc(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_CC("subc.u32", d, a, b);
#else
  d = a - b - cf;
#endif
}

// t[0..W+1] += x y (one word y): one row of the product, in 64-bit C.
// Word j: c = x_j y + t_j + c, its low word out and c >>= 32; x_j y + t_j +
// c <= (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1, so c never overflows.  The
// caller keeps the sum below 2^(32(W+2)).
template <int W>
BLZ_DEVICE void mul_row(uint32_t* t, const uint32_t* x, uint32_t y) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    c += (uint64_t)x[j] * y + t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  c += t[W];
  t[W] = (uint32_t)c;
  t[W + 1] += (uint32_t)(c >> 32);
}

// t <- (t + m p) / 2^32 over the W+2 words of t, m = t[0] n0: one row of
// the REDC, as mul_row.  The low word of t + m p is 0, so the first word's
// sum only carries; t[W+1] becomes 0.
template <int W>
BLZ_DEVICE void redc_row(uint32_t* t, const FieldConsts<W>& fc) {
  const uint32_t m = t[0] * fc.n0;
  uint64_t c = ((uint64_t)m * fc.p[0] + t[0]) >> 32;
#pragma unroll
  for (int j = 1; j < W; ++j) {
    c += (uint64_t)m * fc.p[j] + t[j];
    t[j - 1] = (uint32_t)c;
    c >>= 32;
  }
  c += t[W];
  t[W - 1] = (uint32_t)c;
  t[W] = t[W + 1] + (uint32_t)(c >> 32);
  t[W + 1] = 0;
}

// r = t - p if the W+1 words of t are >= p, else t (r < p for t < 2p).
template <int W>
BLZ_DEVICE void canon_sub(uint32_t* r, const uint32_t* t, const FieldConsts<W>& fc) {
  uint32_t s[W], hi, keep, cf = 0;
  sub_cc(s[0], t[0], fc.p[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(s[j], t[j], fc.p[j], cf);
  subc_cc(hi, t[W], 0, cf);
  subc(keep, 0, 0, cf);                   // all ones iff t < p
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = keep ? t[j] : s[j];
}

// Montgomery product a b / R, the CIOS of the header: W rows of mul_row
// then redc_row.  Lazy: < 2p for a, b < 2p (R > 4p).  Canonical: < p for
// a, b < p.  r may alias a or b.
template <int W, bool kLazy>
BLZ_DEVICE void mont_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                            const FieldConsts<W>& fc) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    mul_row<W>(t, a, b[i]);
    redc_row<W>(t, fc);
  }
  if (kLazy) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = t[j];
  } else {
    canon_sub<W>(r, t, fc);
  }
}

// u[0..W] = (T + m p) / R for the 2W+1 words of T, m = T (-p^-1) mod R:
// redc_row over a window of W+2 words that takes in the next word of T
// after each row.  u[W+1] ends 0 for T < 2^(32(2W+1)) - p R (m < R), as
// for every caller (T < t p^2, t <= 17, or T < p R).
template <int W>
BLZ_DEVICE void redc_window(uint32_t* u, const uint32_t* T, const FieldConsts<W>& fc) {
  uint32_t cf = 0;
#pragma unroll
  for (int j = 0; j <= W; ++j) u[j] = T[j];
  u[W + 1] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    redc_row<W>(u, fc);
    add_cc(u[W], u[W], T[i + W + 1], cf);
    addc(u[W + 1], u[W + 1], 0, cf);
  }
}

// Canonical add and sub (< p for a, b < p), the rules of field.cuh
// fadd/fsub<W, false>: the add subtracts p unless (carry out : sum) < p;
// the sub adds p back on borrow.  r may alias a or b.
template <int W>
BLZ_DEVICE void add_canon(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const FieldConsts<W>& fc) {
  uint32_t s[W + 1], cf = 0;
  add_cc(s[0], a[0], b[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(s[j], a[j], b[j], cf);
  addc(s[W], 0, 0, cf);
  canon_sub<W>(r, s, fc);
}

template <int W>
BLZ_DEVICE void sub_canon(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const FieldConsts<W>& fc) {
  uint32_t d[W], e[W], borrow, cf = 0;
  sub_cc(d[0], a[0], b[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], a[j], b[j], cf);
  subc(borrow, 0, 0, cf);                 // all ones on borrow
  add_cc(e[0], d[0], fc.p[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(e[j], d[j], fc.p[j], cf);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? e[j] : d[j];
}

// acc += a * b: the full 2W-word product (W^2 word products, no
// reduction).  Row i adds a * b[i] at word i as mul_row does; the partial
// product after row i is below 2^(32(W+i+1)), so no carry leaves word i+W.
// Then one carry chain adds it to acc; the caller keeps the sum below
// 2^(32(2W+1)).
template <int W>
BLZ_DEVICE void mul_acc_cc(uint32_t* acc, const uint32_t* a, const uint32_t* b) {
  uint32_t t[2 * W], cf = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      c += (uint64_t)a[j] * b[i] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + W] = (uint32_t)c;
  }
  add_cc(acc[0], acc[0], t[0], cf);
#pragma unroll
  for (int j = 1; j < 2 * W; ++j) addc_cc(acc[j], acc[j], t[j], cf);
  addc(acc[2 * W], acc[2 * W], 0, cf);
}

// r = (T + m p) / R mod p, canonical, for the 2W+1-word sum T in acc of up
// to t products of canonical values (T < t p^2): redc_window, whose value
// is below (subs + 1) p, subs = t p / R + 1; `mults` holds the nm
// multiples 2^b p, b from high to low, W+1 words each, whose conditional
// subtraction brings it below p (fields/kernel_ops.py reduce_multiples).
template <int W>
BLZ_DEVICE void redc_sum(uint32_t* r, const uint32_t* acc, const FieldConsts<W>& fc,
                         const uint32_t* mults, int nm) {
  uint32_t u[W + 2];
  redc_window<W>(u, acc, fc);
  for (int k = 0; k < nm; ++k) {
    const uint32_t* mk = mults + k * (W + 1);
    uint32_t d[W + 1], keep, cf = 0;
    sub_cc(d[0], u[0], mk[0], cf);
#pragma unroll
    for (int j = 1; j <= W; ++j) subc_cc(d[j], u[j], mk[j], cf);
    subc(keep, 0, 0, cf);                 // all ones iff u < 2^b p
#pragma unroll
    for (int j = 0; j <= W; ++j) u[j] = keep ? u[j] : d[j];
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = u[j];
}

}  // namespace blz
