// Complete projective addition (Renes-Costello-Batina 2016 alg 7, a = 0)
// in the lazy < 2p discipline of field.cuh, for K3 (one thread per lane).
//
// Replaces the body of the TPU EC kernels' complete add,
// blaze_tpu/curves/kernels.py ECKernels._add_full_body, including _b3_mul
// (the product with 3b*R).  The formula is the same operation for
// operation, so outputs equal the JAX kernels' lazy limbs exactly (every
// field op here is a function of its input values alone).  K2, K4, K5 and
// K6 run the same formulas split over a team of threads (ec_team.cuh).
// Temporaries are ordered so each dies early: a projective point is 3W
// words and the peak live set is about eight field elements beyond the
// inputs.
#pragma once

#include "field.cuh"

namespace blz {

template <int W>
struct Point {
  uint32_t x[W], y[W], z[W];
};

template <int W>
BLZ_DEVICE void mul_b3(uint32_t* r, const uint32_t* x, const FieldConsts<W>& fc) {
  mont_mul<W, true>(r, fc.b3, x, fc);
}

// o = p + q, complete (RCB alg 7): 12 products plus two with 3b.  o may
// alias p or q.
template <int W>
BLZ_DEVICE_CALL void ec_add_full(Point<W>& o, const Point<W>& p, const Point<W>& q,
                            const FieldConsts<W>& fc) {
  uint32_t m0[W], m1[W], m2[W], t3[W], t4[W], t5[W], a[W], b[W];
  mont_mul<W, true>(m0, p.x, q.x, fc);         // m0 = X1 X2
  mont_mul<W, true>(m1, p.y, q.y, fc);         // m1 = Y1 Y2
  mont_mul<W, true>(m2, p.z, q.z, fc);         // m2 = Z1 Z2
  fadd<W, true>(a, p.x, p.y, fc);              // X1 + Y1
  fadd<W, true>(b, q.x, q.y, fc);              // X2 + Y2
  mont_mul<W, true>(t3, a, b, fc);             // m3
  fadd<W, true>(a, p.y, p.z, fc);              // Y1 + Z1
  fadd<W, true>(b, q.y, q.z, fc);              // Y2 + Z2
  mont_mul<W, true>(t4, a, b, fc);             // m4
  fadd<W, true>(a, p.x, p.z, fc);              // X1 + Z1
  fadd<W, true>(b, q.x, q.z, fc);              // X2 + Z2
  mont_mul<W, true>(t5, a, b, fc);             // m5
  fadd<W, true>(a, m0, m1, fc);                // u0 = m0 + m1
  fsub<W, true>(t3, t3, a, fc);                // t3 = m3 - u0
  fadd<W, true>(a, m1, m2, fc);                // u1 = m1 + m2
  fsub<W, true>(t4, t4, a, fc);                // t4 = m4 - u1
  fadd<W, true>(a, m0, m2, fc);                // u2 = m0 + m2
  fsub<W, true>(t5, t5, a, fc);                // t5 = m5 - u2
  fadd<W, true>(a, m0, m0, fc);                // u3 = m0 + m0
  fadd<W, true>(m0, a, m0, fc);                // t0 = u3 + m0
  mul_b3<W>(a, m2, fc);                        // w0 = 3b m2
  mul_b3<W>(b, t5, fc);                        // w1 = 3b t5
  fadd<W, true>(m2, m1, a, fc);                // z3 = m1 + w0
  fsub<W, true>(t5, m1, a, fc);                // t1 = m1 - w0
  // t0 = m0, t1 = t5, z3 = m2, w1 = b; a and m1 free
  mont_mul<W, true>(a, t3, t5, fc);            // r0 = t3 t1
  mont_mul<W, true>(m1, t4, b, fc);            // r1 = t4 w1
  fsub<W, true>(o.x, a, m1, fc);               // X3 = r0 - r1
  mont_mul<W, true>(a, t5, m2, fc);            // r2 = t1 z3
  mont_mul<W, true>(m1, m0, b, fc);            // r3 = t0 w1
  fadd<W, true>(o.y, a, m1, fc);               // Y3 = r2 + r3
  mont_mul<W, true>(a, m2, t4, fc);            // r4 = z3 t4
  mont_mul<W, true>(m1, m0, t3, fc);           // r5 = t0 t3
  fadd<W, true>(o.z, a, m1, fc);               // Z3 = r4 + r5
}

}  // namespace blz
