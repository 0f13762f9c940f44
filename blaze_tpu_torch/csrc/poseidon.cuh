// The Poseidon permutation of one state, on canonical words (< p) and the
// carry-chain products of carry.cuh.
//
// Used by K10 (poseidon_kernels.cu), one thread per state.  The state's t
// elements live in a per-thread column of shared memory (element e, word w
// at [(e * W + w) * stride]).  Two schedules compute the same permutation:
//
//   sparse (sh.sparse = 1): hash/params.py SparseForm — full rounds mix by
//     the dense M (the last one before the partial rounds by `pre`); a
//     partial round adds one scalar to element 0, takes its x^5, and mixes
//     by a sparse matrix in place: s0' = sum_j row_j s_j (t unreduced
//     products, one multi-p REDC) and s_i' = s_i + col_i s0 (one product
//     each).
//   dense (sh.sparse = 0): every round adds a t-vector and mixes by M, as
//     the TPU kernel does; for instances whose M has a singular lower-right
//     (t-1) x (t-1) block, where the sparse form does not exist.
//
// A dense mix is one sum of t unreduced products and one multi-p REDC per
// row (carry.cuh mul_acc_cc, redc_sum).  It reads every old
// element while it writes the new ones, so it writes a second column and
// the two swap.  Rounds, elements and rows stay rolled loops, so the code
// holds a few inlined products and no unrolled round body (an unrolled,
// register-resident state ran slower on the H100: PERF.md); W-word loops
// are unrolled.
//
// Every thread reads the same constant at the same time, from one constant
// block in device memory (BLZ_LDG, the read-only path), all Montgomery
// forms but the multiples:
//   dense:  rc (rounds, t, W), mds (t, t, W)
//   sparse: rc_full (r_f, t, W), rc_partial (r_p, W), mds (t, t, W),
//           pre (t, t, W), rows (r_p, t, W), cols (r_p, t-1, W)
// then R^2 mod p (W) and the nm multiples 2^b p of redc_sum (W+1 words
// each).  Each launch takes its instance's block by pointer: the leaf
// (t = 12) and node (t = 9) instances run back to back with no shared
// constant symbol between them.
#pragma once

#include "carry.cuh"

#ifndef BLZ_LDG
#define BLZ_LDG(p) __ldg(p)
#endif

namespace blz {

struct PoseidonShape {
  int t, r_f, r_p, nm, sparse;
};

// Pointers into one instance's constant block.
struct PoseidonBlock {
  const uint32_t *rc_full, *rc_partial, *mds, *pre, *rows, *cols, *r2, *mults;

  template <int W>
  BLZ_DEVICE static PoseidonBlock at(const uint32_t* pc, const PoseidonShape& sh) {
    const int t = sh.t;
    PoseidonBlock b;
    b.rc_full = pc;
    if (sh.sparse) {
      b.rc_partial = b.rc_full + sh.r_f * t * W;
      b.mds = b.rc_partial + sh.r_p * W;
      b.pre = b.mds + t * t * W;
      b.rows = b.pre + t * t * W;
      b.cols = b.rows + sh.r_p * t * W;
      b.r2 = b.cols + sh.r_p * (t - 1) * W;
    } else {                   // rc (rounds, t, W), the partial rounds' among them
      b.rc_partial = nullptr;
      b.mds = b.rc_full + (sh.r_f + sh.r_p) * t * W;
      b.pre = b.mds;
      b.rows = b.cols = nullptr;
      b.r2 = b.mds + t * t * W;
    }
    b.mults = b.r2 + W;
    return b;
  }

  // The t-vector of round r (outside the partial rounds when sparse), and
  // the matrix that mixes it (pre = mds when dense).
  template <int W>
  BLZ_DEVICE const uint32_t* rc(int r, const PoseidonShape& sh) const {
    const int half = sh.r_f / 2;
    const int i = (sh.sparse && r >= half) ? r - sh.r_p : r;
    return rc_full + i * sh.t * W;
  }
  BLZ_DEVICE const uint32_t* mix(int r, const PoseidonShape& sh) const {
    return r == sh.r_f / 2 - 1 ? pre : mds;
  }
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

template <int W>
BLZ_DEVICE void sbox(uint32_t* x, const FieldConsts<W>& fc) {
  uint32_t x2[W], x4[W];
  mont_mul_cc<W, false>(x2, x, x, fc);
  mont_mul_cc<W, false>(x4, x2, x2, fc);
  mont_mul_cc<W, false>(x, x4, x, fc);
}

// ARK on every element of the column, x^5 on the first `nsbox`.
template <int W>
BLZ_DEVICE void ark_sbox(uint32_t* s, int stride, int t, const uint32_t* k, int nsbox,
                         const FieldConsts<W>& fc) {
  uint32_t x[W], c[W];
#pragma unroll 1
  for (int e = 0; e < t; ++e) {
    load_el<W>(x, s, e, stride);
    load_const<W>(c, k + e * W);
    fadd<W, false>(x, x, c, fc);
    if (e < nsbox) sbox<W>(x, fc);
    store_el<W>(s, x, e, stride);
  }
}

// Canonical -> Montgomery: x R^2 / R on every element.
template <int W>
BLZ_DEVICE void convert(uint32_t* s, int stride, int t, const uint32_t* r2,
                        const FieldConsts<W>& fc) {
  uint32_t x[W], k[W];
  load_const<W>(k, r2);
#pragma unroll 1
  for (int e = 0; e < t; ++e) {
    load_el<W>(x, s, e, stride);
    mont_mul_cc<W, false>(x, x, k, fc);
    store_el<W>(s, x, e, stride);
  }
}

// ----------------------------------------------------------- the rounds
// nxt = m cur, row by row.
template <int W>
BLZ_DEVICE void mix(uint32_t* nxt, const uint32_t* cur, int stride, int t,
                    const uint32_t* m, const PoseidonShape& sh, const PoseidonBlock& pb,
                    const FieldConsts<W>& fc) {
  uint32_t x[W], k[W];
#pragma unroll 1
  for (int i = 0; i < t; ++i) {
    uint32_t acc[2 * W + 1];
#pragma unroll
    for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
#pragma unroll 1
    for (int j = 0; j < t; ++j) {
      load_el<W>(x, cur, j, stride);
      load_const<W>(k, m + (i * t + j) * W);
      mul_acc_cc<W>(acc, k, x);
    }
    redc_sum<W>(x, acc, fc, pb.mults, sh.nm);
    store_el<W>(nxt, x, i, stride);
  }
}

// One sparse partial round in place: s0 += k, s0 = s0^5, then the sparse
// matrix (row, col).  Row 0's sum reads each old s_i before it is updated.
template <int W>
BLZ_DEVICE void sparse_round(uint32_t* s, int stride, int t, const uint32_t* k,
                             const uint32_t* row, const uint32_t* col, const PoseidonShape& sh,
                             const PoseidonBlock& pb, const FieldConsts<W>& fc) {
  uint32_t x0[W], x[W], c[W], acc[2 * W + 1];
#pragma unroll
  for (int j = 0; j < 2 * W + 1; ++j) acc[j] = 0;
  load_el<W>(x0, s, 0, stride);
  load_const<W>(c, k);
  fadd<W, false>(x0, x0, c, fc);
  sbox<W>(x0, fc);
  load_const<W>(c, row);
  mul_acc_cc<W>(acc, c, x0);
#pragma unroll 1
  for (int i = 1; i < t; ++i) {
    load_el<W>(x, s, i, stride);
    load_const<W>(c, row + i * W);
    mul_acc_cc<W>(acc, c, x);
    load_const<W>(c, col + (i - 1) * W);
    mont_mul_cc<W, false>(c, c, x0, fc);
    fadd<W, false>(x, x, c, fc);
    store_el<W>(s, x, i, stride);
  }
  redc_sum<W>(x, acc, fc, pb.mults, sh.nm);
  store_el<W>(s, x, 0, stride);
}

// Permutes the state in `cur` (Montgomery form in and out; canonical in
// when convert_in); `nxt` is a second column of the same shape, which the
// dense mixes write.  Returns the column (cur or nxt) that holds the
// result.
template <int W>
BLZ_DEVICE uint32_t* poseidon_permute(uint32_t* cur, uint32_t* nxt, int stride,
                                      bool convert_in, const uint32_t* pc,
                                      const PoseidonShape& sh, const FieldConsts<W>& fc) {
  const PoseidonBlock pb = PoseidonBlock::at<W>(pc, sh);
  const int t = sh.t, half = sh.r_f / 2, rounds = sh.r_f + sh.r_p;
  if (convert_in) convert<W>(cur, stride, t, pb.r2, fc);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const bool partial = r >= half && r < half + sh.r_p;
    if (partial && sh.sparse) {
      const int k = r - half;
      sparse_round<W>(cur, stride, t, pb.rc_partial + k * W, pb.rows + k * t * W,
                      pb.cols + k * (t - 1) * W, sh, pb, fc);
      continue;
    }
    ark_sbox<W>(cur, stride, t, pb.rc<W>(r, sh), partial ? 1 : t, fc);
    mix<W>(nxt, cur, stride, t, pb.mix(r, sh), sh, pb, fc);
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  return cur;
}

}  // namespace blz
