// Team group operations for K2 (scan_mixed), K3 (ec_add), K4 (reduce_cols),
// K5 (dbl_n) and K6 (fold_horner): the products of one group operation split
// across a team of kTeam threads.
//
// The formulas and every field operation are RCB 2016 alg 8 and alg 7 in
// the lazy < 2p discipline, as the plain versions compute them
// (curves/ops.py rcb_add_mixed, rcb_add_full, the JAX kernels' bodies
// _add_mixed_body and _add_full_body); only which thread computes which
// product changes.  Every field op is
// a function of its input values alone, so a team's output limbs equal the
// one-thread formulas bit for bit.
//
// Each group op is four steps; inside a step the products are independent:
//   step 1  6 products of the inputs (with the pre-adds X1+Y1 etc.); a
//           doubling (DBL_1) is alg 7's step 1 with the second operand's
//           slots those of the first, the complete add of a point with
//           itself, field op for field op
//   step 2  alg 8: 1 product (3b u2), alg 7: 2 (3b m2, 3b t5), and the
//           linear terms t0, t1, t3, t4, z3
//   step 3  the 6 output products r0..r5
//   step 4  X3 = r0 - r1, Y3 = r2 + r3, Z3 = r4 + r5
// A step is a list of tasks (a short sequence of ops); team member j runs
// tasks j, j + kTeam, ...  Values pass between members through per-lane
// slots in shared memory; the kernel puts a barrier between steps.  With
// kTeam = 6 a group op's critical path is 3 products instead of 13-14
// (on an H100, T = 6 beat T = 2 and 3 at every shape the MSM runs, or
// tied T = 2; see PERF.md).
//
// An op is out = A (kind) B with A = slot a0 (+ slot a1) and B = slot b0
// (+ slot b1): the pre-adds are the formulas' own fadds, done in registers.
// The tables are data, so each step's code holds one product, one add and
// one sub, all inlined (no call frame, no local memory).
//
// The product is carry.cuh's mont_mul_cc<W, true>, the CIOS of field.cuh
// mont_mul<W, true> in PTX carry chains.  Without __CUDA_ARCH__ (a host
// build with g++) every carry instruction is emulated (carry.cuh), so the
// same schedule can be run role by role on the host against the plain
// versions.
#pragma once

#include "carry.cuh"

#ifndef __CUDACC__
#define BLZ_TEAM_TABLE static const
#else
#define BLZ_TEAM_TABLE __constant__
#endif

namespace blz {
namespace team {

constexpr int kTeam = 6;     // threads per lane of K2-K6

// Lazy add and sub, the rules of field.cuh fadd/fsub<W, true>: the add
// ignores its carry out and subtracts 2p unless that borrows; the sub adds
// 2p back (mod R) on borrow.
template <int W>
BLZ_DEVICE void add_lazy(uint32_t* r, const uint32_t* a, const uint32_t* b,
                         const FieldConsts<W>& fc) {
  uint32_t s[W], d[W], cf = 0, borrow;
  add_cc(s[0], a[0], b[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(s[j], a[j], b[j], cf);
  sub_cc(d[0], s[0], fc.p2[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], s[j], fc.p2[j], cf);
  subc(borrow, 0, 0, cf);                  // all ones on borrow
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? s[j] : d[j];
}

template <int W>
BLZ_DEVICE void sub_lazy(uint32_t* r, const uint32_t* a, const uint32_t* b,
                         const FieldConsts<W>& fc) {
  uint32_t d[W], e[W], cf = 0, borrow;
  sub_cc(d[0], a[0], b[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) subc_cc(d[j], a[j], b[j], cf);
  subc(borrow, 0, 0, cf);
  add_cc(e[0], d[0], fc.p2[0], cf);
#pragma unroll
  for (int j = 1; j < W; ++j) addc_cc(e[j], d[j], fc.p2[j], cf);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? e[j] : d[j];
}

// ------------------------------------------------------------------ slots
// Per-lane field elements of a team.  X1..Z1 hold the running point, X2..Z2
// the point added (alg 8 reads X2, Y2), B3 the constant 3b R.  M0..M5 hold
// step 1's products and then step 3's (r0..r5).
enum Slot : uint8_t {
  X1, Y1, Z1, X2, Y2, Z2, B3,
  M0, M1, M2, M3, M4, M5,
  W0, Z3, T1, T5, W1, T3, T4, T0,
  kSlots,
  NONE = 255,
};

enum Kind : uint8_t { NOP, MUL, ADD, SUB };

struct Op {
  uint8_t kind, out, a0, a1, b0, b1;
};

constexpr int kTasks = 6;    // tasks per step, at most
constexpr int kTaskOps = 3;  // ops per task, at most

enum Step { MIXED_1, MIXED_2, FULL_1, DBL_1, FULL_2, OUT_3, OUT_4, kSteps };

#define BLZ_OP(k, o, a0, a1, b0, b1) {k, o, a0, a1, b0, b1}
#define BLZ_NOP {NOP, 0, 0, 0, 0, 0}

// kProgram[step][task][op]: the plain formulas (curves/ops.py), operation
// for operation (a pre-add is written [a0 + a1]).
BLZ_TEAM_TABLE Op kProgram[kSteps][kTasks][kTaskOps] = {
    // MIXED_1: alg 8 products of (X1, Y1, Z1) and the affine (X2, Y2)
    {{BLZ_OP(MUL, M2, X1, Y1, X2, Y2), BLZ_NOP, BLZ_NOP},        // m2 = [X1+Y1][X2+Y2]
     {BLZ_OP(MUL, M0, X1, NONE, X2, NONE), BLZ_NOP, BLZ_NOP},    // m0 = X1 X2
     {BLZ_OP(MUL, M1, Y1, NONE, Y2, NONE), BLZ_NOP, BLZ_NOP},    // m1 = Y1 Y2
     {BLZ_OP(MUL, M3, Y2, NONE, Z1, NONE), BLZ_NOP, BLZ_NOP},    // m3 = Y2 Z1
     {BLZ_OP(MUL, M4, X2, NONE, Z1, NONE), BLZ_NOP, BLZ_NOP},    // m4 = X2 Z1
     {BLZ_OP(MUL, W0, B3, NONE, Z1, NONE), BLZ_NOP, BLZ_NOP}},   // w0 = 3b Z1
    // MIXED_2
    {{BLZ_OP(MUL, W1, B3, NONE, M4, X1), BLZ_NOP, BLZ_NOP},      // w1 = 3b [m4+X1]
     {BLZ_OP(SUB, T3, M2, NONE, M0, M1),                         // t3 = m2 - [m0+m1]
      BLZ_OP(ADD, T4, M3, NONE, Y1, NONE), BLZ_NOP},             // t4 = m3 + Y1
     {BLZ_OP(ADD, T0, M0, M0, M0, NONE),                         // t0 = [m0+m0] + m0
      BLZ_OP(ADD, Z3, M1, NONE, W0, NONE),                       // z3 = m1 + w0
      BLZ_OP(SUB, T1, M1, NONE, W0, NONE)}},                     // t1 = m1 - w0
    // FULL_1: alg 7 products of (X1, Y1, Z1) and (X2, Y2, Z2)
    {{BLZ_OP(MUL, M0, X1, NONE, X2, NONE), BLZ_NOP, BLZ_NOP},    // m0 = X1 X2
     {BLZ_OP(MUL, M1, Y1, NONE, Y2, NONE), BLZ_NOP, BLZ_NOP},    // m1 = Y1 Y2
     {BLZ_OP(MUL, M2, Z1, NONE, Z2, NONE), BLZ_NOP, BLZ_NOP},    // m2 = Z1 Z2
     {BLZ_OP(MUL, M3, X1, Y1, X2, Y2), BLZ_NOP, BLZ_NOP},        // m3 = [X1+Y1][X2+Y2]
     {BLZ_OP(MUL, M4, Y1, Z1, Y2, Z2), BLZ_NOP, BLZ_NOP},        // m4 = [Y1+Z1][Y2+Z2]
     {BLZ_OP(MUL, M5, X1, Z1, X2, Z2), BLZ_NOP, BLZ_NOP}},       // m5 = [X1+Z1][X2+Z2]
    // DBL_1: FULL_1 of (X1, Y1, Z1) and itself
    {{BLZ_OP(MUL, M0, X1, NONE, X1, NONE), BLZ_NOP, BLZ_NOP},    // m0 = X1 X1
     {BLZ_OP(MUL, M1, Y1, NONE, Y1, NONE), BLZ_NOP, BLZ_NOP},    // m1 = Y1 Y1
     {BLZ_OP(MUL, M2, Z1, NONE, Z1, NONE), BLZ_NOP, BLZ_NOP},    // m2 = Z1 Z1
     {BLZ_OP(MUL, M3, X1, Y1, X1, Y1), BLZ_NOP, BLZ_NOP},        // m3 = [X1+Y1][X1+Y1]
     {BLZ_OP(MUL, M4, Y1, Z1, Y1, Z1), BLZ_NOP, BLZ_NOP},        // m4 = [Y1+Z1][Y1+Z1]
     {BLZ_OP(MUL, M5, X1, Z1, X1, Z1), BLZ_NOP, BLZ_NOP}},       // m5 = [X1+Z1][X1+Z1]
    // FULL_2
    {{BLZ_OP(MUL, W0, B3, NONE, M2, NONE),                       // w0 = 3b m2
      BLZ_OP(ADD, Z3, M1, NONE, W0, NONE),                       // z3 = m1 + w0
      BLZ_OP(SUB, T1, M1, NONE, W0, NONE)},                      // t1 = m1 - w0
     {BLZ_OP(SUB, T5, M5, NONE, M0, M2),                         // t5 = m5 - [m0+m2]
      BLZ_OP(MUL, W1, B3, NONE, T5, NONE), BLZ_NOP},             // w1 = 3b t5
     {BLZ_OP(SUB, T3, M3, NONE, M0, M1),                         // t3 = m3 - [m0+m1]
      BLZ_OP(SUB, T4, M4, NONE, M1, M2),                         // t4 = m4 - [m1+m2]
      BLZ_OP(ADD, T0, M0, M0, M0, NONE)}},                       // t0 = [m0+m0] + m0
    // OUT_3: the output products r0..r5
    {{BLZ_OP(MUL, M0, T3, NONE, T1, NONE), BLZ_NOP, BLZ_NOP},    // r0 = t3 t1
     {BLZ_OP(MUL, M1, T4, NONE, W1, NONE), BLZ_NOP, BLZ_NOP},    // r1 = t4 w1
     {BLZ_OP(MUL, M2, T1, NONE, Z3, NONE), BLZ_NOP, BLZ_NOP},    // r2 = t1 z3
     {BLZ_OP(MUL, M3, T0, NONE, W1, NONE), BLZ_NOP, BLZ_NOP},    // r3 = t0 w1
     {BLZ_OP(MUL, M4, Z3, NONE, T4, NONE), BLZ_NOP, BLZ_NOP},    // r4 = z3 t4
     {BLZ_OP(MUL, M5, T0, NONE, T3, NONE), BLZ_NOP, BLZ_NOP}},   // r5 = t0 t3
    // OUT_4: task k writes coordinate k of the sum
    {{BLZ_OP(SUB, X1, M0, NONE, M1, NONE), BLZ_NOP, BLZ_NOP},    // X3 = r0 - r1
     {BLZ_OP(ADD, Y1, M2, NONE, M3, NONE), BLZ_NOP, BLZ_NOP},    // Y3 = r2 + r3
     {BLZ_OP(ADD, Z1, M4, NONE, M5, NONE), BLZ_NOP, BLZ_NOP}},   // Z3 = r4 + r5
};
#undef BLZ_OP
#undef BLZ_NOP

// One team's slots: lane l's element s, words 4q..4q+3, at
// base[(s * W / 4 + q) * kStride] (base already offset by l).  On the
// device kStride is the team's lane count, so a warp's 32 lanes read 32
// consecutive 16-byte words of one slot: no bank conflicts.
template <int W, int kStride>
struct Slots {
  uint4* base;

  BLZ_DEVICE void load(uint32_t* v, int s) const {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 x = base[(s * (W / 4) + q) * kStride];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }

  BLZ_DEVICE void store(int s, const uint32_t* v) const {
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      base[(s * (W / 4) + q) * kStride] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
  }
};

template <int W, int kStride>
BLZ_DEVICE void operand(uint32_t* v, const Slots<W, kStride>& sl, uint8_t s0, uint8_t s1,
                        const FieldConsts<W>& fc) {
  sl.load(v, s0);
  if (s1 != NONE) {
    uint32_t u[W];
    sl.load(u, s1);
    add_lazy<W>(v, v, u, fc);
  }
}

// Team member `member` runs its tasks of step kStep: member, member +
// kTeam, ...  Every branch depends on (step, member) alone, so it is
// uniform over a warp whose 32 threads are one member of 32 teams.
template <int kStep, int W, int kStride>
BLZ_DEVICE void run_step(int member, const Slots<W, kStride>& sl, const FieldConsts<W>& fc) {
  constexpr int kN = (kStep == MIXED_2 || kStep == FULL_2 || kStep == OUT_4) ? 3 : kTasks;
  for (int t = member; t < kN; t += kTeam) {
#pragma unroll 1
    for (int o = 0; o < kTaskOps; ++o) {
      const Op op = kProgram[kStep][t][o];
      if (op.kind == NOP) break;
      uint32_t a[W], b[W], r[W];
      operand<W>(a, sl, op.a0, op.a1, fc);
      operand<W>(b, sl, op.b0, op.b1, fc);
      if (op.kind == MUL) {
        mont_mul_cc<W, true>(r, a, b, fc);
      } else if (op.kind == ADD) {
        add_lazy<W>(r, a, b, fc);
      } else {
        sub_lazy<W>(r, a, b, fc);
      }
      sl.store(op.out, r);
    }
  }
}

}  // namespace team
}  // namespace blz
