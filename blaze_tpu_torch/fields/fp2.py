"""F_p2 = F_p[u] / (u^2 + 1): the coordinates of BN254's G2 (the sextic
twist E'(F_p2), curves/spec.py BN254_G2).

An element c0 + c1 u is 2W int32 words, c0's W words then c1's, each
component in F_p's Montgomery form (so the element's words are its
Montgomery form too: the radix R is an F_p scalar).  A batch of points is
then (..., 3, 2W) and a lanes-major batch (3 * 2W, B), the F_p layouts
with twice the words a coordinate: the MSM engine and the EC kernels' rows
take their sizes from the coordinate's word count and need nothing else.

Two forms, as F_p has (fields/mont.py, fields/kernel_ops.py):

  * `Fp2Field`, the canonical ops `Curve` and the MSM engine run (every
    component below p): add, sub, neg and the conditional subtraction of p
    per component (KF on the card), the product by Karatsuba over three
    F_p products (K1), the inverse through the norm.
  * `PlainFp2Ops`, the lazy 16-bit-limb twin of csrc/ec_team.cuh's Fp2
    (every component below 2p), which the plain versions of the EC
    kernels run: the same Karatsuba on `PlainFieldOps(lazy=True)`, op for
    op, so a plain version equals its kernel word for word.

The product: with u^2 = -1, (a0 + a1 u)(b0 + b1 u) = (t0 - t1) + (t2 - (t0
+ t1)) u, t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .kernel_ops import PlainFieldOps, consts_host
from .mont import Field
from .spec import FieldSpec


def _pair(value) -> tuple:
    """An F_p2 constant as (c0, c1): an int is c0 + 0 u."""
    return (value, 0) if isinstance(value, int) else tuple(value)


def karatsuba(f, a, b):
    """(a0 + a1 u)(b0 + b1 u) over the base field's ops `f` (canonical or
    lazy), a and b (..., 2, n) components: t0 = a0 b0, t1 = a1 b1, t2 = (a0
    + a1)(b0 + b1) in one call of f.mul, then t0 - t1 and t2 - (t0 + t1),
    as (..., 2n)."""
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    t = f.mul(torch.stack([a0, a1, f.add(a0, a1)]), torch.stack([b0, b1, f.add(b0, b1)]))
    return torch.cat([f.sub(t[0], t[1]), f.sub(t[2], f.add(t[0], t[1]))], dim=-1)


@dataclasses.dataclass(frozen=True)
class Fp2Spec:
    """F_p2 = F_p[u] / (u^2 + 1) over `base`: its sizes are twice the base
    field's; p, the radix R and the Montgomery constants are the base's."""

    name: str
    base: FieldSpec

    @property
    def p(self) -> int:
        return self.base.p

    @property
    def r(self) -> int:
        return self.base.r

    @functools.cached_property
    def nwords(self) -> int:
        return 2 * self.base.nwords

    @functools.cached_property
    def nlimbs(self) -> int:
        return 2 * self.base.nlimbs


def fp2_consts_host(spec: Fp2Spec, b3_mont: tuple) -> np.ndarray:
    """The constant block of the EC kernels' F_p2 instances (csrc/ec_team.cuh
    Fp2Consts): the base field's block (consts_host, its 3b slot 0), then
    the F_p2 one (R mod p, 0) and 3b R as 2W words each."""
    W = spec.base.nwords
    words = [v.to_bytes(4 * W, "little") for v in
             (spec.r % spec.p, 0, *(int(x) for x in b3_mont))]
    return np.concatenate([consts_host(spec.base),
                           np.frombuffer(b"".join(words), dtype="<u4")]).astype(np.uint32)


class Fp2Field:
    """Batched canonical F_p2 ops on (..., 2W) int32 words, the interface of
    fields/mont.py Field that `Curve` and the MSM engine use."""

    def __init__(self, spec: Fp2Spec):
        self.spec = spec
        self.base = Field(spec.base)
        self.nwords = spec.nwords
        self._consts: dict = {}

    def _c(self, a: torch.Tensor) -> torch.Tensor:
        """(..., 2W) -> (..., 2, W): the components, a view."""
        return a.reshape(*a.shape[:-1], 2, self.base.nwords)

    def _e(self, c: torch.Tensor) -> torch.Tensor:
        """(..., 2, W) -> (..., 2W)."""
        return c.reshape(*c.shape[:-2], self.nwords)

    def const(self, value, device) -> torch.Tensor:
        """(2W,) int32 words of c0 + c1 u (`value` a pair, or an int c0),
        cached per device."""
        c0, c1 = _pair(value)
        key = (c0, c1, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.cat([self.base.const(c0, device),
                                               self.base.const(c1, device)])
        return t

    # ------------------------------------------------------------------ util
    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros((*batch_shape, self.nwords), dtype=torch.int32, device=device)

    def one(self, batch_shape=(), device="cpu"):
        one = self.const(self.spec.r % self.spec.p, device)
        return one.expand(*batch_shape, self.nwords).clone()

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    # ------------------------------------------------- per component (KF)
    def _cond_sub_p(self, x):
        """Each component below 2p brought below p."""
        return self._e(self.base._cond_sub_p(self._c(x)))

    def add(self, a, b):
        return self._e(self.base.add(self._c(a), self._c(b)))

    def sub(self, a, b):
        return self._e(self.base.sub(self._c(a), self._c(b)))

    def neg(self, a):
        return self._e(self.base.neg(self._c(a)))

    def to_mont(self, a):
        return self._e(self.base.to_mont(self._c(a)))

    def from_mont(self, a):
        return self._e(self.base.from_mont(self._c(a)))

    # ------------------------------------------------------------------ mul
    def mul(self, a, b):
        """Karatsuba: the three F_p products in one K1 call."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return karatsuba(self.base, self._c(a.expand(shape)), self._c(b.expand(shape)))

    def inv(self, a):
        """(a0 - a1 u) / (a0^2 + a1^2); inv(0) = 0."""
        c = self._c(a)
        f = self.base
        sq = f.mul(c, c)
        ninv = f.inv(f.add(sq[..., 0, :], sq[..., 1, :]))
        return self._e(f.mul(torch.stack([c[..., 0, :], f.neg(c[..., 1, :])], dim=-2),
                             ninv[..., None, :]))

    # ------------------------------------------------------- host transfers
    def from_int(self, values, mont=True, device="cpu"):
        """Pairs (c0, c1) (or ints c0) -> (len, 2W) words on `device`."""
        flat = [v for x in values for v in _pair(x)]
        return self._e(self.base.from_int(flat, mont, device).reshape(-1, 2, self.base.nwords))

    def to_int(self, a, mont=True):
        """Device words -> a (c0, c1) pair of ints or nested lists of pairs."""
        vals = self.base.to_int(self._c(a), mont)
        if isinstance(vals[0], int):
            return tuple(vals)

        def pairs(v):
            return tuple(v) if isinstance(v[0], int) else [pairs(x) for x in v]

        return pairs(vals)


class PlainFp2Ops:
    """ec_team.cuh's lazy Fp2 ops on (..., 2L) int64 16-bit limbs, c0's L
    limbs then c1's, every component below 2p."""

    def __init__(self, spec: Fp2Spec):
        self.spec = spec
        self.base = PlainFieldOps(spec.base, lazy=True)
        self.L = spec.nlimbs
        self._consts: dict = {}

    def const(self, value, device) -> torch.Tensor:
        """(2L,) int64 limbs of c0 + c1 u (`value` a pair or an int c0)."""
        c0, c1 = _pair(value)
        key = (c0, c1, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.cat([self.base.const(c0, device),
                                               self.base.const(c1, device)])
        return t

    def _c(self, a):
        return a.reshape(*a.shape[:-1], 2, self.base.L)

    def add(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return self.base.add(self._c(a.expand(shape)), self._c(b.expand(shape))).reshape(shape)

    def sub(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return self.base.sub(self._c(a.expand(shape)), self._c(b.expand(shape))).reshape(shape)

    def mul(self, a, b):
        """Fp2::mul of ec_team.cuh: Karatsuba, every op lazy."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return karatsuba(self.base, self._c(a.expand(shape)), self._c(b.expand(shape)))
