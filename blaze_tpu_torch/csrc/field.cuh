// Montgomery field arithmetic on 32-bit words, for Hopper (sm_90a).
//
// Replaces blaze_tpu/fields/kernel_ops.py PallasFieldOps (the in-kernel
// field library of the TPU kernels) together with carry.cuh.  An element
// is W little-endian 32-bit words (W = 8 for 254/255-bit fields, 12 for the
// 377/381-bit base fields); the Montgomery radix is R = 2^(32W), which
// equals the JAX package's 2^(16L) for its L = 2W 16-bit limbs, so
// Montgomery forms are bit-identical.
//
// This header holds the per-field constants and the C-form add and sub
// (fadd / fsub; K10 adds its round constants with fadd).  The port's one Montgomery
// product and one REDC are carry.cuh's mont_mul_cc, mul_acc_cc and
// redc_sum, which every kernel calls.  What bounds them: the FMA pipe's
// slots (64 per clock per SM; IMAD.HI and IMAD.WIDE take two) and, where
// few warps share an SM, a product's latency.  Each 32 x 32 -> 64-bit word
// product is one IMAD.WIDE whose addend pair the ALU pipe builds (IADD3,
// IADD3.X; ptxas puts about one top bit in two on IMAD.X), so a W-word
// product takes 744 slots at W = 12 and 332 at W = 8, against 909 and 416
// for the lo / hi form (IMAD + IMAD.HI per word product) it replaced.
// carry.cuh's header carries the exactness argument: the product is
// exactly (T + m p) / R with m = T (-p^-1) mod R, the JAX package's
// full-width REDC bit for bit.
//
// Two reduction disciplines, as in kernel_ops.py:
//   kLazy = true   values < 2p (needs R > 4p: the base fields).  Products
//                  skip the final subtraction; add/sub reduce against 2p.
//                  The EC kernels' discipline (ec_team.cuh).
//   kLazy = false  canonical < p.  Products end with one conditional
//                  subtraction of p (tracking the top word); add/sub reduce
//                  against p.  Used by K1, K7-K10.
// The rules match kernel_ops.py:_add_f/_sub_f/_redc exactly (the lazy add
// ignores the carry out, the sub adds the modulus back on borrow modulo R),
// so the EC kernels' lazy outputs equal the JAX kernels' limb for limb.
//
// Multi-p REDC (kernel_ops.py _redc with subs > 1, Poseidon's MDS rows):
// carry.cuh mul_acc_cc sums up to t unreduced W x W products into a
// 2W+1-word accumulator, redc_sum reduces that sum once (the REDC rows of
// the product) and brings the result, below (subs + 1) p, under p by
// conditional subtractions of 2^b p.  The output is canonical, hence
// unique, so it equals the JAX package's quotient-estimate form bit for
// bit.
#pragma once

#include <cstdint>

#ifndef BLZ_DEVICE
#define BLZ_DEVICE __device__ __forceinline__
#endif

namespace blz {

// Per-field constants, passed to every kernel by value (constant bank).
// Host layout (consts_host in the wrappers): p, 2p, R mod p, 3b*R mod p,
// each W words, then -p^-1 mod 2^32.
template <int W>
struct FieldConsts {
  uint32_t p[W];
  uint32_t p2[W];
  uint32_t one[W];
  uint32_t b3[W];
  uint32_t n0;
};

template <int W>
inline FieldConsts<W> load_consts(const uint32_t* h) {
  FieldConsts<W> fc;
  for (int i = 0; i < W; ++i) {
    fc.p[i] = h[i];
    fc.p2[i] = h[W + i];
    fc.one[i] = h[2 * W + i];
    fc.b3[i] = h[3 * W + i];
  }
  fc.n0 = h[4 * W];
  return fc;
}

// r = a + b mod 2^(32W); returns the carry out.
template <int W>
BLZ_DEVICE uint32_t add_words(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b mod 2^(32W); returns the borrow out (0/1).
template <int W>
BLZ_DEVICE uint32_t sub_words(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

template <int W>
BLZ_DEVICE void select_words(uint32_t* r, bool take_a, const uint32_t* a,
                             const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = take_a ? a[i] : b[i];
}

// Field add under the discipline's invariant.  r may alias a or b.
template <int W, bool kLazy>
BLZ_DEVICE void fadd(uint32_t* r, const uint32_t* a, const uint32_t* b,
                     const FieldConsts<W>& fc) {
  uint32_t s[W], d[W];
  const uint32_t top = add_words<W>(s, a, b);
  const uint32_t borrow = sub_words<W>(d, s, kLazy ? fc.p2 : fc.p);
  const bool ge = kLazy ? (borrow == 0) : (top != 0 || borrow == 0);
  select_words<W>(r, ge, d, s);
}

// Field sub: on borrow add the modulus (2p lazy, p canonical) back, mod R.
template <int W, bool kLazy>
BLZ_DEVICE void fsub(uint32_t* r, const uint32_t* a, const uint32_t* b,
                     const FieldConsts<W>& fc) {
  uint32_t d[W], e[W];
  const uint32_t borrow = sub_words<W>(d, a, b);
  add_words<W>(e, d, kLazy ? fc.p2 : fc.p);
  select_words<W>(r, borrow != 0, e, d);
}

}  // namespace blz
