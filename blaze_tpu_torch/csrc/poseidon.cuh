// The Poseidon permutation of one state, on field.cuh's canonical words.
//
// Used by K10 (poseidon_kernels.cu), one thread per state.  The state's t
// elements live in a per-thread column of two buffers (element e, word w
// at [(e * W + w) * stride]), `cur` and `nxt`: the MDS mix reads every old
// element while it writes the new ones.  The rounds, elements and MDS rows
// stay rolled loops, so the code holds a few inlined products and no
// unrolled round body; W-word loops are unrolled (field.cuh).
//
// Every thread reads the same round constant and MDS entry at the same
// time, from one constant block in device memory (BLZ_LDG, the read-only
// path): rc (rounds, t, W), mds (t, t, W), R^2 mod p (W), then the nm
// multiples 2^b p of redc_sum (W+1 words each) — all Montgomery forms but
// the multiples.  Each launch takes its instance's block by pointer: the
// leaf (t = 12) and node (t = 9) instances run back to back with no shared
// constant symbol between them.
#pragma once

#include "field.cuh"

#ifndef BLZ_LDG
#define BLZ_LDG(p) __ldg(p)
#endif

namespace blz {

struct PoseidonShape {
  int t, r_f, r_p, nm;
};

template <int W>
BLZ_DEVICE void load_el(uint32_t* x, const uint32_t* s, int e, int stride) {
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = s[(e * W + w) * stride];
}

template <int W>
BLZ_DEVICE void store_el(uint32_t* s, const uint32_t* x, int e, int stride) {
#pragma unroll
  for (int w = 0; w < W; ++w) s[(e * W + w) * stride] = x[w];
}

template <int W>
BLZ_DEVICE void load_const(uint32_t* x, const uint32_t* g) {
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = BLZ_LDG(g + w);
}

// Permutes the state held in `cur` (Montgomery form in and out; canonical
// form in when convert_in, which multiplies each element by R^2 first).
// Returns the buffer (cur or nxt) that holds the result.
template <int W>
BLZ_DEVICE uint32_t* poseidon_permute(uint32_t* cur, uint32_t* nxt, int stride,
                                      bool convert_in, const uint32_t* pc,
                                      const PoseidonShape& sh,
                                      const FieldConsts<W>& fc) {
  const int t = sh.t;
  const int half = sh.r_f / 2;
  const int rounds = sh.r_f + sh.r_p;
  const uint32_t* rc = pc;
  const uint32_t* mds = rc + rounds * t * W;
  const uint32_t* r2 = mds + t * t * W;
  const uint32_t* mults = r2 + W;
  uint32_t x[W], k[W];

  if (convert_in) {
    load_const<W>(k, r2);
#pragma unroll 1
    for (int e = 0; e < t; ++e) {
      load_el<W>(x, cur, e, stride);
      mont_mul<W, false>(x, x, k, fc);
      store_el<W>(cur, x, e, stride);
    }
  }

#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    // ARK on every element, the x^5 S-box on all (full round) or on
    // element 0 (partial round)
    const int nsbox = (r < half || r >= half + sh.r_p) ? t : 1;
#pragma unroll 1
    for (int e = 0; e < t; ++e) {
      load_el<W>(x, cur, e, stride);
      load_const<W>(k, rc + (r * t + e) * W);
      fadd<W, false>(x, x, k, fc);
      if (e < nsbox) {
        uint32_t x2[W], x4[W];
        mont_mul<W, false>(x2, x, x, fc);
        mont_mul<W, false>(x4, x2, x2, fc);
        mont_mul<W, false>(x, x4, x, fc);
      }
      store_el<W>(cur, x, e, stride);
    }
    // MDS: row i is one sum of t unreduced products and one multi-p REDC
#pragma unroll 1
    for (int i = 0; i < t; ++i) {
      uint32_t acc[2 * W + 1];
#pragma unroll
      for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
#pragma unroll 1
      for (int j = 0; j < t; ++j) {
        load_el<W>(x, cur, j, stride);
        load_const<W>(k, mds + (i * t + j) * W);
        mul_acc<W>(acc, k, x);
      }
      redc_sum<W>(x, acc, fc, mults, sh.nm);
      store_el<W>(nxt, x, i, stride);
    }
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace blz
