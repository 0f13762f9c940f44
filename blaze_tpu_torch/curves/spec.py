"""Curve specifications for the three curves the reference supports
(`blaze/src/ingo_msm/msm_cfg.rs:3-8`: BLS377, BLS381, BN254).

All are short-Weierstrass y^2 = x^3 + b with a = 0, which admits the
branchless *complete* projective formulas (Renes-Costello-Batina 2016)
used by the CUDA kernels — no data-dependent control flow.
"""
from __future__ import annotations

import dataclasses

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
    fq: FieldSpec  # base field (coordinates)
    fr: FieldSpec  # scalar field
    b: int         # curve constant in y^2 = x^3 + b
    gx: int        # generator (affine)
    gy: int

    @property
    def point_bytes(self) -> int:
        """Affine point wire size (x||y LE) — matches msm_cfg point_size."""
        return 2 * self.fq.nbytes

    @property
    def result_bytes(self) -> int:
        """Projective result wire size (z||y||x LE) — msm_cfg result_point_size."""
        return 3 * self.fq.nbytes

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

CURVES = {c.name: c for c in [BN254, BLS12_381, BLS12_377]}

# Aliases matching the reference's enum spelling (msm_cfg.rs:4-7)
CURVE_ALIASES = {"BN254": BN254, "BLS381": BLS12_381, "BLS377": BLS12_377}
