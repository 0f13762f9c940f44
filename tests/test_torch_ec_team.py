"""The team schedule of K2-K6 (blaze_tpu_torch/csrc/ec_team.cuh)
run on the host: the header built with g++, where each PTX carry
instruction is emulated, and each team member's tasks of each step run role
by role, the steps in the kernels' order and the members first to last and
last to first (a task that read another member's output of the same step, a
race on the card, gives a different result in one of the two).  Its outputs
must equal the plain versions of K2-K6 (held limb for limb
against blaze_tpu's Pallas kernels in tests/test_torch_curves.py) and its
product, add and sub the plain lazy field ops, on the three curves' G1
(F_p coordinates, Fp<W>) and on BN254's G2 (F_p2, Fp2<8>: its points from
zkbench/reference/bn254_g2.py).  K6's host loop stages the next window's
coordinates in the same step as OUT_4, as the kernel does.  Skipped
without g++.
"""
import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.curves.kernels import ECKernels
from blaze_tpu_torch.fields.kernel_ops import words_to_limbs16
from blaze_tpu_torch.oracle import ECOracle
from zkbench.reference import bn254_g2

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "blaze_tpu_torch" / "csrc"

HOST_DRIVER = r"""
#define BLZ_DEVICE inline
#include <cstdint>
#include "ec_team.cuh"

namespace tm = blz::team;

// The constants of coordinate field F from the host block.
template <class F>
struct Load;
template <int W>
struct Load<tm::Fp<W>> {
  static blz::FieldConsts<W> from(const uint32_t* h) { return blz::load_consts<W>(h); }
};
template <int W>
struct Load<tm::Fp2<W>> {
  static tm::Fp2Consts<W> from(const uint32_t* h) { return tm::load_consts2<W>(h); }
};

// One step of one lane: every member's tasks, role by role, the members
// in order or in reverse.
template <int S, class F>
void step(const tm::Slots<F::kWords, 1>& sl, const typename F::Consts& fc, int rev) {
  for (int i = 0; i < tm::kTeam; ++i) tm::run_step<S, F>(rev ? tm::kTeam - 1 - i : i, sl, fc);
}

// One group op: the steps in order (the kernels' barriers).
template <int S1, int S2, class F>
void group_op(const tm::Slots<F::kWords, 1>& sl, const typename F::Consts& fc, int rev) {
  step<S1, F>(sl, fc, rev);
  step<S2, F>(sl, fc, rev);
  step<tm::OUT_3, F>(sl, fc, rev);
  step<tm::OUT_4, F>(sl, fc, rev);
}

template <class F>
void init(const tm::Slots<F::kWords, 1>& sl, const typename F::Consts& fc) {
  uint32_t zero[F::kWords] = {};
  sl.store(tm::X1, zero);
  sl.store(tm::Y1, F::one(fc));
  sl.store(tm::Z1, zero);
  sl.store(tm::B3, F::b3(fc));
}

template <int W>
void put(uint32_t* dst, const tm::Slots<W, 1>& sl, int64_t B) {
  for (int k = 0; k < 3; ++k) {
    uint32_t v[W];
    sl.load(v, tm::X1 + k);
    for (int w = 0; w < W; ++w) dst[(k * W + w) * B] = v[w];
  }
}

template <class F>
void scan(const uint32_t* consts, int is_signed, const uint32_t* rows, uint32_t* emitted,
          uint32_t* tot, int C, int64_t B, int rev) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  const int nrows = 2 * W + is_signed;
  uint4 mem[tm::kSlots * W / 4];
  const tm::Slots<W, 1> sl{mem};
  for (int64_t b = 0; b < B; ++b) {
    init<F>(sl, fc);
    for (int c = 0; c < C; ++c) {
      const uint32_t* row = rows + (int64_t)c * nrows * B + b;
      uint32_t x[W], y[W];
      for (int w = 0; w < W; ++w) {
        x[w] = row[w * B];
        y[w] = row[(W + w) * B];
      }
      if (is_signed && row[2 * W * B] != 0) F::neg(y, y, fc);
      sl.store(tm::X2, x);
      sl.store(tm::Y2, y);
      group_op<tm::MIXED_1, tm::MIXED_2, F>(sl, fc, rev);
      put<W>(emitted + (int64_t)c * 3 * W * B + b, sl, B);
    }
    put<W>(tot + b, sl, B);
  }
}

template <class F>
void reduce(const uint32_t* consts, const uint32_t* rows, uint32_t* tot, int C, int64_t B,
            int rev) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  uint4 mem[tm::kSlots * W / 4];
  const tm::Slots<W, 1> sl{mem};
  for (int64_t b = 0; b < B; ++b) {
    init<F>(sl, fc);
    for (int c = 0; c < C; ++c) {
      for (int k = 0; k < 3; ++k) {
        uint32_t v[W];
        for (int w = 0; w < W; ++w) v[w] = rows[((int64_t)c * 3 * W + k * W + w) * B + b];
        sl.store(tm::X2 + k, v);
      }
      group_op<tm::FULL_1, tm::FULL_2, F>(sl, fc, rev);
    }
    put<W>(tot + b, sl, B);
  }
}

// K3's schedule: p + q for each of B lanes (3W, B), p in slot 1 and q in
// slot 2, one FULL_1 group op.
template <class F>
void add(const uint32_t* consts, const uint32_t* p, const uint32_t* q, uint32_t* o,
         int64_t B, int rev) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  uint4 mem[tm::kSlots * W / 4];
  const tm::Slots<W, 1> sl{mem};
  for (int64_t b = 0; b < B; ++b) {
    for (int c = 0; c < 3; ++c) {
      uint32_t u[W], v[W];
      for (int w = 0; w < W; ++w) {
        u[w] = p[(c * W + w) * B + b];
        v[w] = q[(c * W + w) * B + b];
      }
      sl.store(tm::X1 + c, u);
      sl.store(tm::X2 + c, v);
    }
    sl.store(tm::B3, F::b3(fc));
    group_op<tm::FULL_1, tm::FULL_2, F>(sl, fc, rev);
    put<W>(o + b, sl, B);
  }
}

// k doublings of each of B lanes (3W, B), DBL_1 each.
template <class F>
void dbl(const uint32_t* consts, const uint32_t* p, uint32_t* o, int k, int64_t B, int rev) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  uint4 mem[tm::kSlots * W / 4];
  const tm::Slots<W, 1> sl{mem};
  for (int64_t b = 0; b < B; ++b) {
    for (int c = 0; c < 3; ++c) {
      uint32_t v[W];
      for (int w = 0; w < W; ++w) v[w] = p[(c * W + w) * B + b];
      sl.store(tm::X1 + c, v);
    }
    sl.store(tm::B3, F::b3(fc));
    for (int s = 0; s < k; ++s) group_op<tm::DBL_1, tm::FULL_2, F>(sl, fc, rev);
    put<W>(o + b, sl, B);
  }
}

// K6's schedule on (3W, Wn) window sums -> (3W,): step s adds window
// Wn - 2 - s / (c + 1) when s % (c + 1) == c and doubles otherwise; member
// k < 3 stages coordinate k of the next step's window right after its
// tasks of OUT_4.
template <class F>
void fold(const uint32_t* consts, const uint32_t* ws, uint32_t* o, int c, int Wn, int rev) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  uint4 mem[tm::kSlots * W / 4];
  const tm::Slots<W, 1> sl{mem};
  auto put_window = [&](int slot, int m, int w) {
    uint32_t v[W];
    for (int i = 0; i < W; ++i) v[i] = ws[(m * W + i) * Wn + w];
    sl.store(slot + m, v);
  };
  const int steps = (Wn - 1) * (c + 1) > 1 ? (Wn - 1) * (c + 1) : 1;
  for (int m = 0; m < 3; ++m) put_window(tm::X1, m, Wn - 1);
  sl.store(tm::B3, F::b3(fc));
  for (int s = 0; s < steps; ++s) {
    if (s % (c + 1) == c) step<tm::FULL_1, F>(sl, fc, rev);
    else step<tm::DBL_1, F>(sl, fc, rev);
    step<tm::FULL_2, F>(sl, fc, rev);
    step<tm::OUT_3, F>(sl, fc, rev);
    const int n = s + 1;
    for (int i = 0; i < tm::kTeam; ++i) {
      const int m = rev ? tm::kTeam - 1 - i : i;
      tm::run_step<tm::OUT_4, F>(m, sl, fc);
      if (m < 3 && n < steps && n % (c + 1) == c) put_window(tm::X2, m, Wn - 2 - n / (c + 1));
    }
  }
  put<W>(o, sl, 1);
}

// r = a op b for n elements (op 0 product, 1 add, 2 sub), the team's own
// field functions.
template <class F>
void field(const uint32_t* consts, int op, const uint32_t* a, const uint32_t* b,
           uint32_t* r, int64_t n) {
  constexpr int W = F::kWords;
  const auto fc = Load<F>::from(consts);
  for (int64_t i = 0; i < n; ++i) {
    if (op == 0) F::mul(r + i * W, a + i * W, b + i * W, fc);
    else if (op == 1) F::add(r + i * W, a + i * W, b + i * W, fc);
    else F::sub(r + i * W, a + i * W, b + i * W, fc);
  }
}

// W, a coordinate's words: 8 and 12 are F_p, 16 is F_p2 over 8 words.
#define BY_W(call)                                                    \
  if (W == 8) { using F = tm::Fp<8>; call; }                          \
  else if (W == 12) { using F = tm::Fp<12>; call; }                   \
  else { using F = tm::Fp2<8>; call; }

extern "C" void team_scan(int W, const uint32_t* k, int s, const uint32_t* rows,
                          uint32_t* e, uint32_t* t, int C, int64_t B, int rev) {
  BY_W(scan<F>(k, s, rows, e, t, C, B, rev))
}

extern "C" void team_reduce(int W, const uint32_t* k, const uint32_t* rows, uint32_t* t,
                            int C, int64_t B, int rev) {
  BY_W(reduce<F>(k, rows, t, C, B, rev))
}

extern "C" void team_add(int W, const uint32_t* k, const uint32_t* p, const uint32_t* q,
                         uint32_t* o, int64_t B, int rev) {
  BY_W(add<F>(k, p, q, o, B, rev))
}

extern "C" void team_dbl(int W, const uint32_t* k, const uint32_t* p, uint32_t* o, int n,
                         int64_t B, int rev) {
  BY_W(dbl<F>(k, p, o, n, B, rev))
}

extern "C" void team_fold(int W, const uint32_t* k, const uint32_t* ws, uint32_t* o, int c,
                          int Wn, int rev) {
  BY_W(fold<F>(k, ws, o, c, Wn, rev))
}

extern "C" void team_field(int W, const uint32_t* k, int op, const uint32_t* a,
                           const uint32_t* b, uint32_t* r, int64_t n) {
  BY_W(field<F>(k, op, a, b, r, n))
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the team schedule on the host")
    d = tmp_path_factory.mktemp("ec_team")
    (d / "driver.cpp").write_text(HOST_DRIVER)
    so = d / "libteam.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(so), str(d / "driver.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.team_scan.argtypes = [i, p, i, p, p, p, i, ctypes.c_int64, i]
    lib.team_reduce.argtypes = [i, p, p, p, i, ctypes.c_int64, i]
    lib.team_field.argtypes = [i, p, i, p, p, p, ctypes.c_int64]
    lib.team_add.argtypes = [i, p, p, p, p, ctypes.c_int64, i]
    lib.team_dbl.argtypes = [i, p, p, p, i, ctypes.c_int64, i]
    lib.team_fold.argtypes = [i, p, p, p, i, i, i]
    return lib


def ptr(x) -> int:
    return x.ctypes.data if isinstance(x, np.ndarray) else x.data_ptr()


def curve_points(name: str, n: int, seed: int) -> list:
    """n affine points of the curve as ints (pairs of F_p2 pairs on G2):
    the oracle's on G1, the reference's k P2 on G2."""
    if CURVES[name].degree == 2:
        return bn254_g2.subgroup_points(n, seed)
    rng = random.Random(seed)
    oracle = ECOracle(CURVES[name])
    return [oracle.random_point(rng) for _ in range(n)]


def affine_rows(name: str, C: int, B: int, seed: int):
    """(C, 2W, B) Montgomery affine rows of 16 oracle points and a (C, 1, B)
    0/1 sign row."""
    spec = CURVES[name]
    cv = Curve(spec)
    pts = curve_points(name, 16, seed)
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts]),
                       cv.fq.from_int([y for _, y in pts])], dim=1)      # (16, 2, W)
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, 16, size=C * B))
    rows = aff[idx].reshape(C, B, -1).permute(0, 2, 1).contiguous()
    sgn = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 2, size=(C, 1, B)).astype(np.int32))
    return rows, sgn


@pytest.mark.parametrize("rev", [0, 1])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_scan_matches_plain(lib, name, signed, rev):
    k = ECKernels.for_curve(CURVES[name])
    rows, sgn = affine_rows(name, 3, 5, seed=3)
    if signed:
        rows = torch.cat([rows, sgn], dim=1).contiguous()
    C, _, B = rows.shape
    emitted = torch.empty((C, 3 * k.W, B), dtype=torch.int32)
    tot = torch.empty((3 * k.W, B), dtype=torch.int32)
    lib.team_scan(k.W, ptr(k._consts), int(signed), ptr(rows), ptr(emitted), ptr(tot), C, B,
                  rev)
    want_e, want_t = k.scan_mixed_plain(rows)
    assert torch.equal(emitted, want_e)
    assert torch.equal(tot, want_t)


@pytest.mark.parametrize("rev", [0, 1])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_reduce_matches_plain(lib, name, rev):
    """Lazy prefixes (values in [p, 2p) too) with identities among the rows,
    as the bucket sum pads them."""
    k = ECKernels.for_curve(CURVES[name])
    rows, _ = affine_rows(name, 4, 3, seed=13)
    pts = k.scan_mixed_plain(rows)[0].clone()                 # (4, 3W, 3)
    ident = Curve(CURVES[name]).identity().reshape(-1)
    pts[1, :, 0] = ident
    pts[:, :, 2] = ident[None]
    tot = torch.empty((3 * k.W, 3), dtype=torch.int32)
    lib.team_reduce(k.W, ptr(k._consts), ptr(pts), ptr(tot), 4, 3, rev)
    assert torch.equal(tot, k.reduce_cols_plain(pts))


def lazy_points(name: str, n: int, seed: int):
    """(3W, n) lazy projective points (scan prefixes, values in [p, 2p) too),
    the identity at column 1 when n > 2."""
    k = ECKernels.for_curve(CURVES[name])
    rows, _ = affine_rows(name, n, 1, seed)
    pts = k.scan_mixed_plain(rows)[0][:, :, 0].t().contiguous()     # (3W, n)
    if n > 2:
        pts[:, 1] = Curve(CURVES[name]).identity().reshape(-1)
    return pts


@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_add_matches_plain(lib, name):
    """K3's schedule (p in slot 1, q in slot 2, one FULL_1 group op) against
    add_plain on lazy operands: distinct points, p = q, and the identity as
    either operand or both."""
    k = ECKernels.for_curve(CURVES[name])
    pts = lazy_points(name, 9, seed=31)                         # identity at column 1
    p = torch.cat([pts[:, :8], pts[:, 2:5], pts[:, 1:2]], dim=1).contiguous()
    q = torch.cat([pts[:, 1:9], pts[:, 2:5], pts[:, 1:2]], dim=1).contiguous()
    want = k.add_plain(p, q)
    for rev in (0, 1):
        out = torch.empty_like(p)
        lib.team_add(k.W, ptr(k._consts), ptr(p), ptr(q), ptr(out), p.shape[1], rev)
        assert torch.equal(out, want), rev


@pytest.mark.parametrize("k_dbl", [1, 16])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_dbl_n_matches_plain(lib, name, k_dbl):
    """K5's schedule: k self-adds of each lane, an identity lane included."""
    k = ECKernels.for_curve(CURVES[name])
    pts = lazy_points(name, 5, seed=21)
    want = k.dbl_n_plain(pts, k_dbl)
    for rev in (0, 1):
        out = torch.empty_like(pts)
        lib.team_dbl(k.W, ptr(k._consts), ptr(pts), ptr(out), k_dbl, pts.shape[1], rev)
        assert torch.equal(out, want), rev


@pytest.mark.parametrize("Wn,c", [(1, 16), (2, 16), (2, 13), (20, 13)])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_fold_horner_matches_plain(lib, name, Wn, c):
    """K6's schedule against fold_horner_plain: one window (a single
    doubling, as the TPU kernel's grid of one step), two, and the MSM's 20
    windows of c = 13, with an identity window among them."""
    k = ECKernels.for_curve(CURVES[name])
    ws = lazy_points(name, Wn, seed=Wn + c)
    want = k.fold_horner_plain(ws, c)
    for rev in (0, 1):
        out = torch.empty(3 * k.W, dtype=torch.int32)
        lib.team_fold(k.W, ptr(k._consts), ptr(ws), ptr(out), c, Wn, rev)
        assert torch.equal(out, want), rev


@pytest.mark.parametrize("name", sorted(CURVES))
def test_team_field_ops_match_plain(lib, name):
    """The carry-chain product, add and sub on lazy operands below 2p,
    edges included (0, 1, p - 1, p, 2p - 1)."""
    fq = CURVES[name].fq
    k = ECKernels.for_curve(CURVES[name])
    rng = random.Random(7)
    p = fq.p
    edge = [0, 1, p - 1, p, 2 * p - 1]
    vals = edge + [rng.randrange(2 * p) for _ in range(59)]
    if CURVES[name].degree == 2:        # F_p2: c1 from the edges and at random too
        vals = [(v, w) for v, w in zip(vals, vals[5:] + edge)][:40]
    a_int = [v for v in vals for _ in vals]
    b_int = [v for _ in vals for v in vals]

    def words(ints):
        return np.stack([np.frombuffer(b"".join(c.to_bytes(4 * fq.nwords, "little")
                                                for c in np.atleast_1d(
                                                    np.array(v, dtype=object))),
                                       dtype="<u4") for v in ints]).astype(np.uint32)

    a, b = words(a_int), words(b_int)
    for op, plain in enumerate((k.ops.mul, k.ops.add, k.ops.sub)):
        r = np.empty_like(a)
        lib.team_field(k.W, ptr(k._consts), op, ptr(a), ptr(b), ptr(r), a.shape[0])
        want = plain(words_to_limbs16(torch.from_numpy(a.view(np.int32))),
                     words_to_limbs16(torch.from_numpy(b.view(np.int32))))
        assert torch.equal(words_to_limbs16(torch.from_numpy(r.view(np.int32))), want), op
