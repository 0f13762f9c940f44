"""BN254's G2 in plain Python ints: the bases of the Groth16 [B]_2 cell and
the MSM they must give.

G2 is the order-r subgroup of the sextic twist E'(F_p2): y^2 = x^3 + b with
b = 3 / (9 + u), over F_p2 = F_p[u] / (u^2 + 1).  An F_p2 element c0 + c1 u
is the pair (c0, c1); an affine point a pair of such pairs, None the
identity.  The constants are EIP-197's, by value: the twist's b and the
generator P2.  Independent of the program: no import of it, nor of JAX.
"""
from __future__ import annotations

import random

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

B = (19485874751759354771024239261021720505790618469301721065564631296452457478373,
     266929791119991161246907387137283842545076965332900288569378510910307636690)
G = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
      11559732032986387107991004021392285783925812861821192530917403151452391805634),
     (8495653923123431417604973247489272438418190587263600148770280649306958101930,
      4082367875863433681332203403145435568316851327593401208105741076214120093531))

ZERO, ONE = (0, 0), (1, 0)


# ------------------------------------------------------------------ F_p2
def add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def mul(a, b):
    """(a0 + a1 u)(b0 + b1 u) with u^2 = -1."""
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def scale(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2); a nonzero."""
    n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * n % P, -a[1] * n % P)


# ---------------------------------------------------------------- the twist
def on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return mul(y, y) == add(mul(mul(x, x), x), B)


def neg(pt):
    return None if pt is None else (pt[0], sub(ZERO, pt[1]))


def point_add(p1, p2):
    """The affine group law (chord and tangent)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if add(y1, y2) == ZERO:
            return None
        lam = mul(scale(mul(x1, x1), 3), inv(scale(y1, 2)))
    else:
        lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    return (x3, sub(mul(lam, sub(x1, x3)), y1))


# Jacobian (X, Y, Z) ~ (X / Z^2, Y / Z^3); Z = 0 is the identity.
def _jdbl(q):
    X, Y, Z = q
    if Z == ZERO or Y == ZERO:
        return (ONE, ONE, ZERO)
    yy = mul(Y, Y)
    s = scale(mul(X, yy), 4)
    m = scale(mul(X, X), 3)
    x3 = sub(mul(m, m), scale(s, 2))
    return (x3, sub(mul(m, sub(s, x3)), scale(mul(yy, yy), 8)), scale(mul(Y, Z), 2))


def _jadd_affine(q, pt):
    X, Y, Z = q
    if Z == ZERO:
        return (pt[0], pt[1], ONE)
    zz = mul(Z, Z)
    h = sub(mul(pt[0], zz), X)
    rr = sub(mul(mul(pt[1], zz), Z), Y)
    if h == ZERO:
        return _jdbl(q) if rr == ZERO else (ONE, ONE, ZERO)
    hh = mul(h, h)
    hhh = mul(h, hh)
    v = mul(X, hh)
    x3 = sub(sub(mul(rr, rr), hhh), scale(v, 2))
    return (x3, sub(mul(rr, sub(v, x3)), mul(Y, hhh)), mul(Z, h))


def to_affine(q):
    """Jacobian -> affine (None for Z = 0)."""
    X, Y, Z = q
    if Z == ZERO:
        return None
    zi = inv(Z)
    zi2 = mul(zi, zi)
    return (mul(X, zi2), mul(mul(Y, zi2), zi))


def point_mul(pt, k: int, reduce: bool = True):
    """k pt by double-and-add, k taken mod r (pt of order r) unless
    `reduce` is false (to check an order)."""
    if reduce:
        k %= R
    if pt is None or k == 0:
        return None
    q = (pt[0], pt[1], ONE)
    for bit in bin(k)[3:]:
        q = _jdbl(q)
        if bit == "1":
            q = _jadd_affine(q, pt)
    return to_affine(q)


def msm(points, scalars):
    acc = None
    for pt, s in zip(points, scalars):
        acc = point_add(acc, point_mul(pt, s))
    return acc


def subgroup_points(count: int, seed: int, multiplier_bits: int = 64) -> list:
    """`count` points k_u P2 of G2, k_u drawn from `seed` (multiplier_bits
    bits, never 0)."""
    rng = random.Random(seed)
    return [point_mul(G, rng.randrange(1, 1 << multiplier_bits)) for _ in range(count)]


def tiled_msm(points: list, class_sums: list):
    """sum_i s_i P_(i mod U) over the tiled bases, from the class sums S_u =
    sum_(i = u mod U) s_i: sum_u S_u P_u."""
    return msm(points, class_sums)
