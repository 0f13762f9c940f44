// Montgomery field arithmetic on 32-bit words, for Hopper (sm_90a).
//
// Replaces blaze_tpu/fields/kernel_ops.py PallasFieldOps (the in-kernel
// field library of the TPU kernels).  An element is W little-endian 32-bit
// words (W = 8 for 254/255-bit fields, 12 for the 377/381-bit base fields);
// the Montgomery radix is R = 2^(32W), which equals the JAX package's
// 2^(16L) for its L = 2W 16-bit limbs, so Montgomery forms are bit-identical.
//
// What bounds it: the 32-bit multiply-adds of the product (2W^2 + W wide
// products, each a lo and a hi IMAD).  A whole element lives in registers;
// every loop below is unrolled at compile time, so a value never touches
// memory between operations.
//
// Montgomery product: word-serial CIOS.  It yields exactly (T + m p) / R with
// m = T (-p^-1) mod R — the unique m < R making the sum divisible by R — so
// it equals the JAX package's full-width REDC bit for bit.
//
// Two reduction disciplines, as in kernel_ops.py:
//   kLazy = true   values < 2p (needs R > 4p: the base fields).  Products
//                  skip the final subtraction; add/sub reduce against 2p.
//                  The EC kernels' discipline (ec_team.cuh runs it in
//                  carry.cuh's carry chains).
//   kLazy = false  canonical < p.  Products end with one conditional
//                  subtraction of p (tracking the top word); add/sub reduce
//                  against p.  Used by K1, K8, K9 and K10.
// The rules match kernel_ops.py:_add_f/_sub_f/_redc exactly (the lazy add
// ignores the carry out, the sub adds the modulus back on borrow modulo R),
// so the EC kernels' lazy outputs equal the JAX kernels' limb for limb.
//
// Multi-p REDC (kernel_ops.py _redc with subs > 1, Poseidon's MDS rows):
// carry.cuh mul_acc_cc sums up to t unreduced W x W products into a
// 2W+1-word accumulator, redc_sum reduces that sum once (the reduction
// half of the CIOS) and brings the result, below (subs + 1) p, under p by
// conditional subtractions of 2^b p.  The output is canonical, hence unique, so it
// equals the JAX package's quotient-estimate form bit for bit.
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

// Montgomery product a * b / R (CIOS).  r may alias a or b.
template <int W, bool kLazy>
BLZ_DEVICE void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                         const FieldConsts<W>& fc) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t bi = b[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      c += (uint64_t)a[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W] = (uint32_t)c;
    t[W + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * fc.n0;
    c = ((uint64_t)m * fc.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      c += (uint64_t)m * fc.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W - 1] = (uint32_t)c;
    t[W] = t[W + 1] + (uint32_t)(c >> 32);
  }
  if (kLazy) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = t[j];
  } else {
    uint32_t s[W];
    const uint32_t borrow = sub_words<W>(s, t, fc.p);
    select_words<W>(r, t[W] != 0 || borrow == 0, s, t);
  }
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

// r = (T + m p) / R mod p, canonical, for the 2W+1-word sum T in acc of up
// to t products of canonical values (T < t p^2; acc is overwritten).  The
// word-serial m digits form m = T (-p^-1) mod R, so the reduced value is
// exactly (T + m p) / R < (subs + 1) p, subs = t p / R + 1; `mults` holds
// the nm multiples 2^b p, b from high to low, W+1 words each, whose
// conditional subtraction brings it below p (fields/kernel_ops.py
// reduce_multiples).
template <int W>
BLZ_DEVICE void redc_sum(uint32_t* r, uint32_t* acc, const FieldConsts<W>& fc,
                         const uint32_t* mults, int nm) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t m = acc[i] * fc.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      c += (uint64_t)m * fc.p[j] + acc[i + j];
      acc[i + j] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int j = i + W; j <= 2 * W; ++j) {
      c += acc[j];
      acc[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  uint32_t* u = acc + W;                 // W+1 words
  for (int k = 0; k < nm; ++k) {
    uint32_t d[W + 1];
    const uint32_t borrow = sub_words<W + 1>(d, u, mults + k * (W + 1));
    select_words<W + 1>(u, borrow == 0, d, u);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = u[j];
}

}  // namespace blz
