"""Branchless elliptic-curve group ops for y^2 = x^3 + b (a = 0).

Complete homogeneous-projective formulas from Renes-Costello-Batina 2016
(algorithms 7/8/9 for j-invariant 0): a single code path handles doubling,
inverses and the identity.  Points are `int32[..., 3, W]` (X, Y, Z word
rows, Montgomery form); identity is (0 : 1 : 0).

The alg 7 and alg 8 formulas are written once (`rcb_add_full`,
`rcb_add_mixed`) over any field-ops object F with broadcasting mul / add /
sub, given 3b in F's representation: `Curve.add` and `Curve.add_mixed`
run them on the canonical Field, and the plain versions of the EC kernels
(curves/kernels.py) run both on the lazy 16-bit-limb twin of
csrc/field.cuh.
Independent products of one formula are stacked into one batched call.
"""
from __future__ import annotations

import torch

from ..fields.mont import Field
from .spec import CurveSpec


def b3_mont(spec: CurveSpec) -> int:
    """3b in Montgomery form, the constant of every RCB formula."""
    return (3 * spec.b % spec.fq.p) * spec.fq.r % spec.fq.p


def rcb_add_full(F, b3, X1, Y1, Z1, X2, Y2, Z2):
    """RCB 2016 alg 7 (a = 0): complete projective add, 12 products plus
    two with 3b, in three waves."""
    st = torch.stack
    s = F.add(st([X1, X2, Y1, Y2, X1, X2]), st([Y1, Y2, Z1, Z2, Z1, Z2]))
    m = F.mul(st([X1, Y1, Z1, s[0], s[2], s[4]]),
              st([X2, Y2, Z2, s[1], s[3], s[5]]))
    m0, m1, m2 = m[0], m[1], m[2]                # X1X2, Y1Y2, Z1Z2
    u = F.add(st([m0, m1, m0, m0]), st([m1, m2, m2, m0]))
    v = F.sub(m[3:6], u[0:3])                    # t3, t4, t5 cross sums
    t3, t4, t5 = v[0], v[1], v[2]
    t0 = F.add(u[3], m0)                         # 3 X1X2
    w = F.mul(b3, st([m2, t5]))
    z3 = F.add(m1, w[0])                         # Y1Y2 + 3bZ1Z2
    t1 = F.sub(m1, w[0])                         # Y1Y2 - 3bZ1Z2
    r = F.mul(st([t3, t4, t1, t0, z3, t0]), st([t1, w[1], z3, w[1], t4, t3]))
    return F.sub(r[0], r[1]), F.add(r[2], r[3]), F.add(r[4], r[5])


def rcb_add_mixed(F, b3, X1, Y1, Z1, X2, Y2):
    """RCB 2016 alg 8 (a = 0): projective + affine (X2, Y2), 11 products
    plus two with 3b.  The affine operand cannot be the identity."""
    st = torch.stack
    s = F.add(st([X1, X2]), st([Y1, Y2]))
    m = F.mul(st([X1, Y1, s[0], Y2, X2]), st([X2, Y2, s[1], Z1, Z1]))
    m0, m1 = m[0], m[1]
    u = F.add(st([m0, m[3], m[4], m0]), st([m1, Y1, X1, m0]))
    t3 = F.sub(m[2], u[0])                       # X1Y2 + X2Y1
    t4 = u[1]                                    # Y1 + Y2Z1
    t0 = F.add(u[3], m0)                         # 3 X1X2
    w = F.mul(b3, st([Z1, u[2]]))                # 3bZ1, 3b(X1 + X2Z1)
    z3 = F.add(m1, w[0])
    t1 = F.sub(m1, w[0])
    r = F.mul(st([t3, t4, t1, t0, z3, t0]), st([t1, w[1], z3, w[1], t4, t3]))
    return F.sub(r[0], r[1]), F.add(r[2], r[3]), F.add(r[4], r[5])


class Curve:
    """Batched group ops bound to one CurveSpec, on the canonical Field."""

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.fq = Field(spec.fq)
        self._b3 = b3_mont(spec)

    # ------------------------------------------------------------ structure
    @property
    def nwords(self):
        return self.fq.nwords

    @property
    def nlimbs(self):
        """16-bit limbs per base-field element (the JAX package's L = 2W)."""
        return self.fq.spec.nlimbs

    @staticmethod
    def pack(x, y, z):
        return torch.stack([x, y, z], dim=-2)

    @staticmethod
    def unpack(p):
        return p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def identity(self, batch_shape=(), device="cpu"):
        f = self.fq
        return self.pack(f.zeros(batch_shape, device), f.one(batch_shape, device),
                         f.zeros(batch_shape, device))

    def is_identity(self, p):
        """Boolean (...,): true where Z = 0, the identity (0 : 1 : 0)."""
        return self.fq.is_zero(p[..., 2, :])

    @staticmethod
    def select(cond, p, q):
        """where(cond, p, q) over points; cond shaped (...,)."""
        return torch.where(cond[..., None, None], p, q)

    def neg(self, p):
        x, y, z = self.unpack(p)
        return self.pack(x, self.fq.neg(y), z)

    # ---------------------------------------------------------- group law
    def add(self, p, q):
        """Complete projective addition (RCB alg 7, a=0)."""
        shape = torch.broadcast_shapes(p.shape, q.shape)
        X3, Y3, Z3 = rcb_add_full(self.fq, self.fq.const(self._b3, p.device),
                                  *self.unpack(p.expand(shape)),
                                  *self.unpack(q.expand(shape)))
        return self.pack(X3, Y3, Z3)

    def add_mixed(self, p, q_affine):
        """Complete mixed addition (RCB alg 8, a=0): p projective, q affine
        (..., 2, W).  Handles p = identity; q must be a real point (the
        affine encoding cannot express the identity)."""
        shape = torch.broadcast_shapes(p.shape[:-2], q_affine.shape[:-2])
        W = self.nwords
        p = p.expand(*shape, 3, W)
        q = q_affine.expand(*shape, 2, W)
        X3, Y3, Z3 = rcb_add_mixed(self.fq, self.fq.const(self._b3, p.device),
                                   *self.unpack(p), q[..., 0, :], q[..., 1, :])
        return self.pack(X3, Y3, Z3)

    def dbl(self, p):
        """Complete doubling (RCB alg 9, a=0). 6M + 2S, wave-batched."""
        f = self.fq
        X, Y, Z = self.unpack(p)
        m = f.mul(torch.stack([Y, Y, Z, X]), torch.stack([Y, Z, Z, Y]))
        t0 = m[0]
        d1 = f.add(m[0], m[0])
        d2 = f.add(d1, d1)
        z3 = f.add(d2, d2)                       # 8 Y^2
        t2 = f.mul(f.const(self._b3, p.device), m[2])   # 3b Z^2
        y3p = f.add(t0, t2)                      # Y^2 + 3bZ^2
        t2_3 = f.add(f.add(t2, t2), t2)          # 9b Z^2
        t0 = f.sub(t0, t2_3)                     # Y^2 - 9bZ^2
        r = f.mul(torch.stack([t2, m[1], t0, t0]),
                  torch.stack([z3, z3, y3p, m[3]]))
        Y3 = f.add(r[0], r[2])
        X3 = f.add(r[3], r[3])
        Z3 = r[1]
        return self.pack(X3, Y3, Z3)

    # ------------------------------------------------------------- checks
    def on_curve(self, p):
        """Boolean (...,): the projective equation Y^2 Z = X^3 + b Z^3, scaled
        by 3 to use the 3b constant (3 Y^2 Z = 3 X^3 + 3b Z^3).  The identity
        passes."""
        f = self.fq
        X, Y, Z = self.unpack(p)
        sq = f.mul(torch.stack([Y, X, Z]), torch.stack([Y, X, Z]))      # Y^2, X^2, Z^2
        cu = f.mul(sq, torch.stack([Z, X, Z]))                          # Y^2 Z, X^3, Z^3
        bz3 = f.mul(f.const(self._b3, p.device), cu[2])
        lhs3 = f.add(f.add(cu[0], cu[0]), cu[0])
        rhs3 = f.add(f.add(f.add(cu[1], cu[1]), cu[1]), bz3)
        return (lhs3 == rhs3).all(dim=-1)

    # --------------------------------------------------------- conversions
    def to_affine(self, p):
        """Projective -> affine (..., 2, W); identity maps to (0, 0)."""
        f = self.fq
        X, Y, Z = self.unpack(p)
        zinv = f.inv(Z)
        return torch.stack([f.mul(X, zinv), f.mul(Y, zinv)], dim=-2)

    def from_affine(self, q_affine):
        """Affine (..., 2, W) -> projective with Z = 1 (Montgomery one)."""
        x = q_affine[..., 0, :]
        y = q_affine[..., 1, :]
        return self.pack(x, y, self.fq.one(x.shape[:-1], x.device))

    # -------------------------------------------------------- scalar mul
    def scalar_mul(self, p, k: int):
        """p * k for a Python-int scalar (test and oracle use): double-and-add
        from the identity over the bits of k mod r, top bit first, the add
        taken where the bit is set (a host branch: the bits are known).  The
        JAX package runs all of r's bits to keep one traced loop body; the
        doublings of the identity above k's top bit change nothing, so they
        are left out."""
        k %= self.spec.fr.p
        acc = self.identity(p.shape[:-2], p.device)
        for i in reversed(range(k.bit_length())):
            acc = self.dbl(acc)
            if k >> i & 1:
                acc = self.add(acc, p)
        return acc
