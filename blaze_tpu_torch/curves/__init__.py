from .spec import CurveSpec, CURVES, CURVE_ALIASES, BN254, BLS12_381, BLS12_377
from .ops import Curve
from .codec import (
    decode_affine_points,
    encode_affine_points,
    decode_scalars,
    encode_scalars,
    encode_projective_result,
    decode_projective_result,
)

__all__ = [
    "CurveSpec",
    "Curve",
    "CURVES",
    "CURVE_ALIASES",
    "BN254",
    "BLS12_381",
    "BLS12_377",
    "decode_affine_points",
    "encode_affine_points",
    "decode_scalars",
    "encode_scalars",
    "encode_projective_result",
    "decode_projective_result",
]
