"""BLS12-381 G1 in plain Python ints: the bases the MSM cell uses and the
MSM they must give.

A frozen copy of the program's plain golden model (Jacobian double-and-add
on y^2 = x^3 + b), with the curve's published constants.
"""
from __future__ import annotations

import random

from .fields import MODULI

CURVES = {
    "bls12_381": {
        "p": MODULI["bls12_381_fq"],
        "r": MODULI["bls12_381_fr"],
        "b": 4,
        "g": (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
              0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
    },
}


class G1:
    """Affine points are (x, y) tuples, None the identity."""

    def __init__(self, curve: str):
        c = CURVES[curve]
        self.p, self.r, self.b, self.g = c["p"], c["r"], c["b"], c["g"]

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.p == 0

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        (x1, y1), (x2, y2), P = p1, p2, self.p
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return None
            lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        return (x3, (lam * (x1 - x3) - y1) % P)

    # Jacobian (X, Y, Z) ~ (X/Z^2, Y/Z^3); Z = 0 is the identity.
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
        """k pt, k taken mod r (pt of order r), by double-and-add."""
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


def subgroup_points(curve: str, count: int, seed: int, multiplier_bits: int = 64) -> list:
    """`count` points of the order-r subgroup, k_u G with k_u drawn from
    `seed` (multiplier_bits bits, never 0): distinct with overwhelming
    probability, and as good as any for Pippenger, whose work does not
    depend on the points' values."""
    g1, rng = G1(curve), random.Random(seed)
    return [g1.mul(g1.g, rng.randrange(1, 1 << multiplier_bits)) for _ in range(count)]


def tiled_msm(curve: str, points: list, class_sums: list):
    """sum_i s_i P_(i mod U) over the tiled bases, from the class sums
    S_u = sum_(i = u mod U) s_i: sum_u S_u P_u (scalars act mod r on the
    order-r points)."""
    return G1(curve).msm(points, class_sums)
