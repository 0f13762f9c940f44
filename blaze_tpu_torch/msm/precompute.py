"""Precomputed point multiples — the reference's 8x precompute mode.

The reference's MSM engine accepts each base point together with its
multiples by 2^(32*i), i = 0..factor-1 (PRECOMPUTE_FACTOR = 8,
`blaze/src/ingo_msm/msm_api.rs:39-40`; oracle expansion at
`blaze/tests/msm/mod.rs:360-380`), which shortens the scalar seen
by the engine to 32 bits.  Same contract here: an MSM over N points with
b-bit scalars becomes an MSM over factor*N points with ceil(b/factor)-bit
scalars.

Layout contract: expanded points are ordered multiple-major —
`expanded[i * N + n] = 2^(shift_bits * i) * P_n` — matching the sliced
scalar layout produced by `split_scalars`.
"""
from __future__ import annotations

import torch

from ..curves.ops import Curve
from ..fields.spec import LIMB_BITS


def shift_bits_for(scalar_bits: int, factor: int) -> int:
    """Bits each precomputed multiple absorbs; multiple of the 16-bit limb
    so scalar slicing stays a limb reshape (32 for 256-bit/factor 8 — the
    reference's exact geometry)."""
    per = -(-scalar_bits // factor)
    return -(-per // LIMB_BITS) * LIMB_BITS


def precompute_points(curve: Curve, points_aff_mont: torch.Tensor, factor: int,
                      scalar_bits: int | None = None) -> torch.Tensor:
    """(N, 2, W) affine Montgomery -> (factor*N, 2, W), multiple-major:
    factor-1 rounds of `shift_bits` doublings each, each round normalised
    back to affine."""
    if factor <= 1:
        return points_aff_mont
    bits = shift_bits_for(scalar_bits or curve.spec.fr.bits, factor)
    outs = [points_aff_mont]
    cur = curve.from_affine(points_aff_mont)
    for _ in range(factor - 1):
        for _ in range(bits):
            cur = curve.dbl(cur)
        outs.append(curve.to_affine(cur))
    return torch.cat(outs, dim=0)


def split_scalars(scalars: torch.Tensor, factor: int, scalar_bits: int):
    """(N, Ls) limbs -> (factor*N, Ls_short) limbs, multiple-major.

    Slice i holds scalar bits [i*shift, (i+1)*shift) of every element —
    the digits that multiply 2^(shift*i) * P."""
    if factor <= 1:
        return scalars, scalar_bits
    bits = shift_bits_for(scalar_bits, factor)
    limbs_per = bits // LIMB_BITS
    n, ls = scalars.shape
    want = factor * limbs_per
    if ls < want:
        scalars = torch.nn.functional.pad(scalars, (0, want - ls))
    sliced = scalars[:, :want].reshape(n, factor, limbs_per)
    return sliced.transpose(0, 1).reshape(factor * n, limbs_per), bits
