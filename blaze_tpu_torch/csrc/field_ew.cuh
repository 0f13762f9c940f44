// KF's element function: one canonical field add, sub, neg, double or
// conditional subtraction of p on W 32-bit words, in carry.cuh's chains.
//
// The results are word for word those of fields/elementwise.py
// field_ew_plain (the int64 Kogge-Stone path, as blaze_tpu/fields/mont.py
// computes Field.add / sub / neg / double / _cond_sub_p), for any input
// words, not only canonical ones: every op is a fixed chain mod 2^(32W)
// and one select.  Built by field_ew.cu for the card, and by g++ on the
// host (BLZ_DEVICE inline) in the tier-1 tests.
#pragma once

#include "carry.cuh"

namespace blz {

// Op codes of blz_field_ew, in the order of fields/elementwise.py OPS.
enum FieldEwOp { kEwAdd = 0, kEwSub = 1, kEwNeg = 2, kEwDouble = 3, kEwCanon = 4 };

// p - a mod 2^(32W), and 0 for a = 0 (Field.neg: the select keeps a zero).
template <int W>
BLZ_DEVICE void neg_canon(uint32_t* r, const uint32_t* a, const FieldConsts<W>& fc) {
  uint32_t d[W], nz = 0, cf = 0;
  sub_cc(d[0], fc.p[0], a[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], fc.p[j], a[j], cf);
#pragma unroll
  for (int j = 0; j < W; ++j) nz |= a[j];
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = nz ? d[j] : 0u;
}

// x - p mod 2^(32W) where top * 2^(32W) + x >= p, else x (Field._cond_sub_p;
// with top = 0 it brings a lazy value below 2p under p).
template <int W>
BLZ_DEVICE void cond_sub_p(uint32_t* r, const uint32_t* x, uint32_t top,
                           const FieldConsts<W>& fc) {
  uint32_t d[W], borrow, cf = 0;
  sub_cc(d[0], x[0], fc.p[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], x[j], fc.p[j], cf);
  subc(borrow, 0, 0, cf);                 // all ones iff x < p
  const bool keep = top == 0 && borrow != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = keep ? x[j] : d[j];
}

// r = op(a, b); b is unused by neg, double and canon, top only by canon.
// r may alias a or b.
template <int W>
BLZ_DEVICE void field_ew_element(int op, uint32_t* r, const uint32_t* a, const uint32_t* b,
                                 uint32_t top, const FieldConsts<W>& fc) {
  switch (op) {
    case kEwAdd:
      add_canon<W>(r, a, b, fc);
      break;
    case kEwSub:
      sub_canon<W>(r, a, b, fc);
      break;
    case kEwNeg:
      neg_canon<W>(r, a, fc);
      break;
    case kEwDouble:
      add_canon<W>(r, a, a, fc);
      break;
    default:
      cond_sub_p<W>(r, a, top, fc);
  }
}

}  // namespace blz
