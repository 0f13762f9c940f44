"""Pure-python CPU golden model for curve/MSM correctness.

Plays the role of the arkworks-based oracle in the reference's integration
tests (`blaze/tests/msm/mod.rs`): generates random points, computes
expected MSMs with plain integer arithmetic, and checks on-curve + equality
after projective normalization (mod.rs:397-419).
"""
from __future__ import annotations

import random

from ..curves.spec import CurveSpec


class ECOracle:
    """Slow, obviously-correct big-int EC arithmetic for one curve."""

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.p = spec.fq.p
        self.r = spec.fr.p
        self.b = spec.b

    # points are (x, y) int tuples or None for the identity
    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.b)) % self.p == 0

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        P = self.p
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        y3 = (lam * (x1 - x3) - y1) % P
        return (x3, y3)

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def dbl(self, pt):
        return self.add(pt, pt)

    # Jacobian (X, Y, Z) ~ (X/Z^2, Y/Z^3), Z = 0 the identity: `mul` adds
    # and doubles without an inversion each (y^2 = x^3 + b, a = 0), then
    # returns to affine once.
    def _jdbl(self, q):
        X, Y, Z = q
        P = self.p
        if Z == 0 or Y == 0:
            return (1, 1, 0)
        yy = Y * Y % P
        s = 4 * X * yy % P
        m = 3 * X * X % P
        x3 = (m * m - 2 * s) % P
        return (x3, (m * (s - x3) - 8 * yy * yy) % P, 2 * Y * Z % P)

    def _jadd_affine(self, q, pt):
        X, Y, Z = q
        P = self.p
        if Z == 0:
            return (pt[0], pt[1], 1)
        zz = Z * Z % P
        h = (pt[0] * zz - X) % P
        rr = (pt[1] * zz * Z - Y) % P
        if h == 0:
            return self._jdbl(q) if rr == 0 else (1, 1, 0)
        hh = h * h % P
        hhh = h * hh % P
        v = X * hh % P
        x3 = (rr * rr - hhh - 2 * v) % P
        return (x3, (rr * (v - x3) - Y * hhh) % P, Z * h % P)

    def mul(self, pt, k: int):
        """k pt (k mod r), by double-and-add from k's top bit."""
        k %= self.r
        if pt is None or k == 0:
            return None
        q = (pt[0], pt[1], 1)
        for bit in bin(k)[3:]:
            q = self._jdbl(q)
            if bit == "1":
                q = self._jadd_affine(q, pt)
        X, Y, Z = q
        if Z == 0:
            return None
        zi = pow(Z, -1, self.p)
        zi2 = zi * zi % self.p
        return (X * zi2 % self.p, Y * zi2 * zi % self.p)

    def msm(self, points, scalars):
        acc = None
        for pt, s in zip(points, scalars):
            acc = self.add(acc, self.mul(pt, s))
        return acc

    # ------------------------------------------------------------- sampling
    def sqrt(self, a: int):
        """Tonelli-Shanks; returns None if a is not a QR."""
        P = self.p
        a %= P
        if a == 0:
            return 0
        if pow(a, (P - 1) // 2, P) != 1:
            return None
        if P % 4 == 3:
            return pow(a, (P + 1) // 4, P)
        # general Tonelli-Shanks
        q, s = P - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (P - 1) // 2, P) != P - 1:
            z += 1
        m, c, t, rr = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % P
                i += 1
            bexp = pow(c, 1 << (m - i - 1), P)
            m, c = i, bexp * bexp % P
            t, rr = t * c % P, rr * bexp % P
        return rr

    def random_point(self, rng: random.Random):
        """Uniform-ish curve point by x-coordinate rejection sampling."""
        while True:
            x = rng.randrange(self.p)
            y = self.sqrt((x * x * x + self.b) % self.p)
            if y is not None:
                if rng.randrange(2):
                    y = self.p - y
                return (x, y)

    def random_subgroup_point(self, rng: random.Random):
        """A point of the order-r subgroup: a random multiple of the
        generator.  random_point may lie outside it where the cofactor is
        not 1 (BLS12-377/381 G1); on such points scalars act mod the point's
        order, not mod r, so sums of scalars must not be reduced mod r."""
        return self.mul(self.generator, rng.randrange(1, self.r))

    @property
    def generator(self):
        return (self.spec.gx, self.spec.gy)
