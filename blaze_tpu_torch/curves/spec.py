"""Curve specifications: G1 of the three curves the reference supports
(`blaze/src/ingo_msm/msm_cfg.rs:3-8`: BLS377, BLS381, BN254), and BN254's
G2, the group of a Groth16 proof's B (EIP-197), which blaze does not serve.

All are short-Weierstrass y^2 = x^3 + b with a = 0, which admits the
branchless *complete* projective formulas (Renes-Costello-Batina 2016)
used by the CUDA kernels — no data-dependent control flow.  G1's
coordinates lie in F_p (degree 1); G2's in F_p2 = F_p[u] / (u^2 + 1)
(degree 2, fields/fp2.py), its b and generator given as (c0, c1) pairs,
c0 + c1 u.
"""
from __future__ import annotations

import dataclasses
import functools

from ..fields.fp2 import Fp2Spec
from ..fields.spec import (
    FieldSpec,
    BN254_FQ,
    BN254_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    BLS12_377_FQ,
    BLS12_377_FR,
)


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    fq: FieldSpec  # base field (of the coordinates' components)
    fr: FieldSpec  # scalar field
    b: int | tuple   # curve constant in y^2 = x^3 + b (a pair at degree 2)
    gx: int | tuple  # generator (affine)
    gy: int | tuple
    degree: int = 1  # the coordinates' field: F_p (1) or F_p2 (2)

    @functools.cached_property
    def coords(self):
        """The coordinates' field: `fq`, or its F_p2 at degree 2."""
        return self.fq if self.degree == 1 else Fp2Spec(f"{self.fq.name}2", self.fq)

    @property
    def point_bytes(self) -> int:
        """Affine point wire size (x||y LE) — matches msm_cfg point_size."""
        return 2 * self.degree * self.fq.nbytes

    @property
    def result_bytes(self) -> int:
        """Projective result wire size (z||y||x LE) — msm_cfg result_point_size."""
        return 3 * self.degree * self.fq.nbytes

    @property
    def scalar_bytes(self) -> int:
        return self.fr.nbytes


BN254 = CurveSpec(
    name="bn254",
    fq=BN254_FQ,
    fr=BN254_FR,
    b=3,
    gx=1,
    gy=2,
)

BLS12_381 = CurveSpec(
    name="bls12_381",
    fq=BLS12_381_FQ,
    fr=BLS12_381_FR,
    b=4,
    gx=3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    gy=1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
)

BLS12_377 = CurveSpec(
    name="bls12_377",
    fq=BLS12_377_FQ,
    fr=BLS12_377_FR,
    b=1,
    gx=81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    gy=241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)

# BN254's G2: the order-r subgroup of the sextic twist y^2 = x^3 + 3 / (9 +
# u) over F_p2, generator P2; b and P2 by value from EIP-197 (b = 3 / (9 +
# u), 3b = 9 / (9 + u)).
BN254_G2 = CurveSpec(
    name="bn254_g2",
    fq=BN254_FQ,
    fr=BN254_FR,
    b=(19485874751759354771024239261021720505790618469301721065564631296452457478373,
       266929791119991161246907387137283842545076965332900288569378510910307636690),
    gx=(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    gy=(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531),
    degree=2,
)

CURVES = {c.name: c for c in [BN254, BLS12_381, BLS12_377, BN254_G2]}
# The G1 curves: blaze's wire formats and clients, and the JAX package's
G1_CURVES = {n: c for n, c in CURVES.items() if c.degree == 1}

# Aliases matching the reference's enum spelling (msm_cfg.rs:4-7)
CURVE_ALIASES = {"BN254": BN254, "BLS381": BLS12_381, "BLS377": BLS12_377}
