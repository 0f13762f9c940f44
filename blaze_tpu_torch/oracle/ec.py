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

    def mul(self, pt, k: int):
        k %= self.r
        acc = None
        add = pt
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.dbl(add)
            k >>= 1
        return acc

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
