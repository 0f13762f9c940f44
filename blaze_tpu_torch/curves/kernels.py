"""K2-K6: the MSM's EC kernels (csrc/ec_kernels.cu) and their plain versions.

Replaces blaze_tpu/curves/kernels.py ECKernels.  Layout is lanes-major: a
batch of B projective points is (3W, B) int32 words (X, Y, Z word rows,
lane b in column b), an affine row (2W, B).  All values stay in the lazy
< 2p range of csrc/field.cuh; callers canonicalize where the JAX package
does (msm/pippenger.py).

Each public method launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it only for CPU tensors.  The plain versions compute
the same function on 16-bit int64 limbs with the lazy twin of field.cuh
(fields/kernel_ops.py) and the shared RCB formulas (curves/ops.py), so the
CPU tests hold them limb for limb against the JAX kernels in interpret mode.
Bounds and design: see csrc/ec_kernels.cu; K2, K4, K5 and K6 split each
group op over a team of threads per lane (csrc/ec_team.cuh).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields.kernel_ops import (
    PlainFieldOps,
    consts_host,
    limbs16_to_words,
    words_to_limbs16,
)
from .ops import b3_mont, rcb_add_full, rcb_add_mixed
from .spec import CurveSpec

_c = ctypes
_ARGTYPES = {
    "blz_scan_mixed": [_c.c_int, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_void_p,
                       _c.c_void_p, _c.c_int, _c.c_int64, _c.c_void_p],
    "blz_ec_add": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_int64, _c.c_void_p],
    "blz_reduce_cols": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                        _c.c_int64, _c.c_void_p],
    "blz_dbl_n": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                  _c.c_int64, _c.c_void_p],
    "blz_fold_horner": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                        _c.c_int, _c.c_void_p],
    "blz_product_chain": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                          _c.c_int, _c.c_void_p],
}


def _entry(name: str):
    fn = getattr(_build.load("ec_kernels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


class ECKernels:
    """Per-curve EC kernels. Cached per CurveSpec."""

    _CACHE: dict = {}

    @classmethod
    def for_curve(cls, spec: CurveSpec) -> "ECKernels":
        inst = cls._CACHE.get(spec.name)
        if inst is None:
            inst = cls._CACHE[spec.name] = cls(spec)
        return inst

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.W = spec.fq.nwords
        self.L = spec.fq.nlimbs
        self.ops = PlainFieldOps(spec.fq, lazy=True)
        self._b3 = b3_mont(spec)
        self._consts = consts_host(spec.fq, self._b3)

    # ------------------------------------------------------------ plumbing
    def _check(self, x: torch.Tensor, rows: int, what: str, ndim: int = 2) -> None:
        if x.dtype != torch.int32 or x.dim() != ndim or x.shape[-2] != rows:
            raise ValueError(
                f"{what}: want int32 with {rows} rows, got {tuple(x.shape)} {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: unsupported device {x.device}")

    def _launch(self, name: str, counter: str, dev: torch.device, *args) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _entry(name)(self.W, self._consts.ctypes.data, *args, stream)
        _build.check(rc, name)
        _build.LAUNCHES[counter] += 1

    def _pm(self, x: torch.Tensor) -> torch.Tensor:
        """(k*W, B) int32 words -> (B, k, L) int64 limbs (plain versions)."""
        kW, B = x.shape
        return words_to_limbs16(x.reshape(kW // self.W, self.W, B).permute(2, 0, 1))

    def _lm(self, x: torch.Tensor) -> torch.Tensor:
        """(..., B, 3, L) int64 limbs -> (..., 3W, B) int32 words."""
        w = limbs16_to_words(x)
        return w.reshape(*w.shape[:-2], 3 * self.W).transpose(-1, -2).contiguous()

    def _ident(self, B: int, device) -> tuple:
        zero = torch.zeros((B, self.L), dtype=torch.int64, device=device)
        one = self.ops.const(self.spec.fq.r % self.spec.fq.p, device)
        return zero, one.expand(B, self.L), zero

    # ----------------------------------------------------------------- K2
    def scan_mixed_plain(self, rows: torch.Tensor):
        """Plain PyTorch version of `scan_mixed` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        C, nrows, B = rows.shape
        W = self.W
        acc = self._ident(B, rows.device)
        emitted = []
        for c in range(C):
            xy = self._pm(rows[c, : 2 * W])
            x2, y2 = xy[:, 0], xy[:, 1]
            if nrows == 2 * W + 1:
                neg = self.ops.sub(self.ops.const(2 * self.spec.fq.p, rows.device), y2)
                y2 = torch.where((rows[c, 2 * W] != 0)[:, None], neg, y2)
            acc = rcb_add_mixed(self.ops, self.ops.const(self._b3, rows.device),
                                *acc, x2, y2)
            emitted.append(torch.stack(acc, dim=-2))
        emitted = self._lm(torch.stack(emitted))
        return emitted, emitted[-1].clone()

    def scan_mixed(self, rows: torch.Tensor):
        """Per-lane inclusive EC prefix of sorted affine points (alg 8).

        rows: (C, 2W, B) int32 affine Montgomery rows (X words, Y words),
        or (C, 2W + 1, B) whose last row is the digit sign (nonzero: the
        point enters negated, Y -> 2p - Y).  Returns (emitted, tot):
        emitted (C, 3W, B) every prefix, tot (3W, B) the last one."""
        C, nrows, B = rows.shape
        if nrows not in (2 * self.W, 2 * self.W + 1):
            raise ValueError(f"scan rows: {nrows} not 2W or 2W+1 (W={self.W})")
        self._check(rows, nrows, "rows", ndim=3)
        if rows.device.type == "cpu":
            return self.scan_mixed_plain(rows)
        emitted = torch.empty((C, 3 * self.W, B), dtype=torch.int32, device=rows.device)
        tot = torch.empty((3 * self.W, B), dtype=torch.int32, device=rows.device)
        if C and B:
            self._launch("blz_scan_mixed", "scan_mixed", rows.device,
                         int(nrows == 2 * self.W + 1), rows.data_ptr(),
                         emitted.data_ptr(), tot.data_ptr(), C, B)
        return emitted, tot

    # ----------------------------------------------------------------- K3
    def add_plain(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of `add` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        a, b = self._pm(p), self._pm(q)
        out = rcb_add_full(self.ops, self.ops.const(self._b3, p.device),
                           a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])
        return self._lm(torch.stack(out, dim=-2))

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Batched complete projective add (alg 7): (3W, B) x2 -> (3W, B)."""
        self._check(p, 3 * self.W, "p")
        self._check(q, 3 * self.W, "q")
        if p.shape != q.shape or p.device != q.device:
            raise ValueError("operands differ in shape or device")
        if p.device.type == "cpu":
            return self.add_plain(p, q)
        out = torch.empty_like(p)
        if p.shape[1]:
            self._launch("blz_ec_add", "ec_add", p.device, p.data_ptr(),
                         q.data_ptr(), out.data_ptr(), p.shape[1])
        return out

    # ----------------------------------------------------------------- K4
    def reduce_cols_plain(self, rows: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of `reduce_cols` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        acc = self._ident(rows.shape[2], rows.device)
        for c in range(rows.shape[0]):
            q = self._pm(rows[c])
            acc = rcb_add_full(self.ops, self.ops.const(self._b3, rows.device),
                               *acc, q[:, 0], q[:, 1], q[:, 2])
        return self._lm(torch.stack(acc, dim=-2))

    def reduce_cols(self, rows: torch.Tensor) -> torch.Tensor:
        """Lane-wise EC sum over axis 0: (C, 3W, B) -> (3W, B), starting from
        the identity (complete adds, so rows may hold identities)."""
        self._check(rows, 3 * self.W, "rows", ndim=3)
        if rows.device.type == "cpu":
            return self.reduce_cols_plain(rows)
        C, _, B = rows.shape
        tot = torch.empty((3 * self.W, B), dtype=torch.int32, device=rows.device)
        if B:
            self._launch("blz_reduce_cols", "reduce_cols", rows.device,
                         rows.data_ptr(), tot.data_ptr(), C, B)
        return tot

    # ----------------------------------------------------------------- K5
    def dbl_n_plain(self, pts: torch.Tensor, k: int) -> torch.Tensor:
        """Plain PyTorch version of `dbl_n` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        a = self._pm(pts)
        acc = (a[:, 0], a[:, 1], a[:, 2])
        for _ in range(k):
            acc = rcb_add_full(self.ops, self.ops.const(self._b3, pts.device),
                               *acc, *acc)
        return self._lm(torch.stack(acc, dim=-2))

    def dbl_n(self, pts: torch.Tensor, k: int) -> torch.Tensor:
        """k successive doublings (complete add with itself) of every lane."""
        if k <= 0:
            return pts
        self._check(pts, 3 * self.W, "pts")
        if pts.device.type == "cpu":
            return self.dbl_n_plain(pts, k)
        out = torch.empty_like(pts)
        if pts.shape[1]:
            self._launch("blz_dbl_n", "dbl_n", pts.device, pts.data_ptr(),
                         out.data_ptr(), k, pts.shape[1])
        return out

    # ----------------------------------------------------------------- K6
    def fold_horner_plain(self, ws: torch.Tensor, c: int) -> torch.Tensor:
        """Plain PyTorch version of `fold_horner` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        Wn = ws.shape[1]
        w = self._pm(ws)                                  # (Wn, 3, L)
        acc = (w[Wn - 1 : Wn, 0], w[Wn - 1 : Wn, 1], w[Wn - 1 : Wn, 2])
        for s in range(max((Wn - 1) * (c + 1), 1)):
            r, pos = divmod(s, c + 1)
            q = w[Wn - 2 - r : Wn - 1 - r].unbind(1) if pos == c else acc
            acc = rcb_add_full(self.ops, self.ops.const(self._b3, ws.device),
                               *acc, *q)
        return self._lm(torch.stack(acc, dim=-2))[:, 0]

    def fold_horner(self, ws: torch.Tensor, c: int) -> torch.Tensor:
        """Horner window fold sum_w 2^(c w) ws[:, w] of (3W, Wn) window sums
        -> (3W,), one chain of group ops on one team (doubling = add with
        itself)."""
        self._check(ws, 3 * self.W, "ws")
        if c < 1 or ws.shape[1] < 1:
            raise ValueError(f"fold: want c >= 1 and a window, got c={c}, Wn={ws.shape[1]}")
        if ws.device.type == "cpu":
            return self.fold_horner_plain(ws, c)
        out = torch.empty((3 * self.W, 1), dtype=torch.int32, device=ws.device)
        self._launch("blz_fold_horner", "fold_horner", ws.device, ws.data_ptr(),
                     out.data_ptr(), c, ws.shape[1])
        return out[:, 0]

    # --------------------------------------------------------- measurement
    def product_chain_plain(self, x: torch.Tensor, y: torch.Tensor, n: int) -> torch.Tensor:
        """Plain version of `product_chain`."""
        a, b = words_to_limbs16(x), words_to_limbs16(y)
        for _ in range(n):
            a = self.ops.mul(a, b)
        return limbs16_to_words(a)

    def product_chain(self, x: torch.Tensor, y: torch.Tensor, n: int) -> torch.Tensor:
        """x y^n / R^n by n dependent lazy products on one thread of the card
        (x, y: (W,) words below 2p): timed, it gives one product's latency,
        the unit of K5's and K6's chain bound.  Not a kernel of any path."""
        for v in (x, y):
            if v.dtype != torch.int32 or v.shape != (self.W,) or v.device.type != "cuda":
                raise ValueError(f"want ({self.W},) int32 words on the card")
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            rc = _entry("blz_product_chain")(self.W, self._consts.ctypes.data, x.data_ptr(),
                                             y.data_ptr(), out.data_ptr(), n,
                                             torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(rc, "blz_product_chain")
        return out
