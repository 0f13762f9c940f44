// Multi-word arithmetic in PTX carry chains, for Hopper (sm_90a).
//
// One copy of the carry-chain primitives and the products built on them,
// shared by K2-K6 (ec_team.cuh, lazy products), K7 (ntt.cuh, canonical
// products, adds and subs) and K10 (poseidon.cuh, canonical products and
// unreduced sums).  Each add.cc / addc / mad.lo.cc
// / madc.hi.cc is one PTX instruction that reads or writes the carry flag,
// in place of field.cuh's 64-bit sums and shifts; the values computed are
// field.cuh's, word for word.
//
// cf is the carry (borrow for sub) flag of the host emulation: without
// __CUDA_ARCH__ (a host build with g++) every instruction is emulated with
// it, so the device code can be run on the host against the plain
// versions.  On the device it is the hardware CC.CF and the argument is
// unused; the asm statements are volatile, so the compiler keeps each
// chain in order.
#pragma once

#include "field.cuh"

#ifndef __CUDACC__
struct uint4 {
  uint32_t x, y, z, w;
};
#endif

namespace blz {

// cf is the carry (borrow for sub) flag of the host emulation; on the
// device it is the hardware CC.CF and the argument is unused.
#ifdef __CUDA_ARCH__
#define BLZ_CC(ins, d, a, b) \
  asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#define BLZ_MAD(ins, d, a, b) \
  asm volatile(ins " %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b))
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

BLZ_DEVICE void madc_hi(uint32_t& d, uint32_t a, uint32_t b, uint32_t& cf) {
#ifdef __CUDA_ARCH__
  BLZ_MAD("madc.hi.u32", d, a, b);
#else
  d += (uint32_t)(((uint64_t)a * b) >> 32) + cf;
#endif
}

// t[0..W+1] += x * y (x = a, one word y): the low halves at words 0..W-1,
// the high halves at words 1..W, carries into t[W] and t[W+1].
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

// Montgomery product a * b / R: the word-serial CIOS of field.cuh
// mont_mul<W, kLazy>, the same (T + m p) / R, m = T (-p^-1) mod R.  Lazy:
// < 2p for a, b < 2p (R > 4p).  Canonical: < p for a, b < p, by one
// conditional subtraction of p that tracks the top word.  r may alias a
// or b.
template <int W, bool kLazy>
BLZ_DEVICE void mont_mul_cc(uint32_t* r, const uint32_t* a, const uint32_t* b,
                            const FieldConsts<W>& fc) {
  uint32_t t[W + 2], cf = 0;
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    mul_word_acc<W>(t, a, b[i], cf);
    const uint32_t m = t[0] * fc.n0;
    mul_word_acc<W>(t, fc.p, m, cf);        // t[0] becomes 0
#pragma unroll
    for (int j = 0; j <= W; ++j) t[j] = t[j + 1];
    t[W + 1] = 0;
  }
  if (kLazy) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = t[j];
  } else {
    uint32_t s[W], hi, keep;
    sub_cc(s[0], t[0], fc.p[0], cf);
#pragma unroll
    for (int j = 1; j < W; ++j) subc_cc(s[j], t[j], fc.p[j], cf);
    subc_cc(hi, t[W], 0, cf);
    subc(keep, 0, 0, cf);                   // all ones iff t < p
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = keep ? t[j] : s[j];
  }
}

// Canonical add and sub (< p for a, b < p), the rules of field.cuh
// fadd/fsub<W, false>: the add subtracts p unless (carry out : sum) < p;
// the sub adds p back on borrow.  r may alias a or b.
template <int W>
BLZ_DEVICE void add_canon(uint32_t* r, const uint32_t* a, const uint32_t* b,
                          const FieldConsts<W>& fc) {
  uint32_t s[W], d[W], top, hi, keep, cf = 0;
  add_cc(s[0], a[0], b[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(s[j], a[j], b[j], cf);
  addc(top, 0, 0, cf);
  sub_cc(d[0], s[0], fc.p[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], s[j], fc.p[j], cf);
  subc_cc(hi, top, 0, cf);
  subc(keep, 0, 0, cf);                   // all ones iff (top : s) < p
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = keep ? s[j] : d[j];
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

// acc += a * b: the full 2W-word product (W^2 wide multiply-adds, no
// reduction), in carry chains.  Row i adds a * b[i] at word i, its low halves
// then its high halves; the partial product after row i is below
// 2^(32(W+i+1)), so no carry leaves word i+W.  The caller keeps the sum
// below 2^(32(2W+1)).
template <int W>
BLZ_DEVICE void mul_acc_cc(uint32_t* acc, const uint32_t* a, const uint32_t* b) {
  uint32_t t[2 * W], cf = 0;
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    mad_lo_cc(t[i], a[0], b[i], cf);
#pragma unroll
    for (int j = 1; j < W; ++j) madc_lo_cc(t[i + j], a[j], b[i], cf);
    addc(t[i + W], t[i + W], 0, cf);
    mad_hi_cc(t[i + 1], a[0], b[i], cf);
#pragma unroll
    for (int j = 1; j < W - 1; ++j) madc_hi_cc(t[i + j + 1], a[j], b[i], cf);
    madc_hi(t[i + W], a[W - 1], b[i], cf);
  }
  add_cc(acc[0], acc[0], t[0], cf);
#pragma unroll
  for (int j = 1; j < 2 * W; ++j) addc_cc(acc[j], acc[j], t[j], cf);
  addc(acc[2 * W], acc[2 * W], 0, cf);
}

}  // namespace blz
