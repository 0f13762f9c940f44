"""BN254 (alt_bn128) G1 for the plain reference: Ethereum's pairing curve,
y^2 = x^3 + 3 over F_p with generator (1, 2) and a group of prime order r
(cofactor 1), the constants by value from EIP-196.

Importing this module adds the curve to `ec.CURVES` under "bn254", beside
BLS12-381, so that `ec.G1`, `ec.subgroup_points` and `ec.tiled_msm` serve
it; the arithmetic is ec.py's.
"""
from __future__ import annotations

from . import ec

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

ec.CURVES.setdefault("bn254", {"p": P, "r": R, "b": 3, "g": (1, 2)})
