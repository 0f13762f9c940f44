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
scalar layout produced by `split_scalars`.  On resident operands the
bases are (2W, factor*N) columns in the same order (`precompute_resident`)
and the scalars stay (Ls, N): multiple i reads limb rows
[i * shift/16, (i+1) * shift/16) of them in place (`scalar_rows`).
"""
from __future__ import annotations

import torch

from ..curves.kernels import ECKernels
from ..curves.ops import Curve
from ..fields.spec import LIMB_BITS
from ..trace import span


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


def scalar_rows(scalars: torch.Tensor, factor: int, scalar_bits: int):
    """(Ls, N) resident limbs -> ([factor (limbs_per, N) row blocks], bits):
    block i holds bits [i*shift, (i+1)*shift) of every scalar, the digits
    that multiply 2^(shift*i) * P.  Each block is a view of `scalars`; a
    last block that runs past its rows is that view zero-padded.  Factor 1
    is the scalars and scalar_bits as they are (as split_scalars)."""
    if factor <= 1:
        return [scalars], scalar_bits
    bits = shift_bits_for(scalar_bits, factor)
    per = bits // LIMB_BITS
    blocks = []
    for i in range(factor):
        rows = scalars[i * per:(i + 1) * per]
        if rows.shape[0] < per:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, per - rows.shape[0]))
        blocks.append(rows)
    return blocks, bits


def precompute_resident(curve: Curve, resident: torch.Tensor, factor: int,
                        scalar_bits: int | None = None, block: int = 1 << 20) -> torch.Tensor:
    """(2W, N) resident Montgomery bases -> (2W, factor*N) resident
    multiples, multiple-major: the words of `precompute_points` followed by
    `points_to_resident`, made `block` bases at a time into one
    preallocated residency, so that what it holds besides is bounded by the
    block, not by N.  Per block: the factor-1 rounds of `shift_bits`
    doublings on K5, then one batched normalisation to affine (Fermat on
    K1, KF) of all of them."""
    W2, N = resident.shape
    out = torch.empty((W2, factor * N), dtype=resident.dtype, device=resident.device)
    with span("blaze.msm.precompute"):
        out[:, :N] = resident
        if factor <= 1:
            return out
        W = W2 // 2
        bits = shift_bits_for(scalar_bits or curve.spec.fr.bits, factor)
        kern = ECKernels.for_curve(curve.spec)
        for lo in range(0, N, block):
            hi = min(lo + block, N)
            cur = torch.cat([resident[:, lo:hi],
                             curve.fq.one((hi - lo,), resident.device).t()])  # (3W, B)
            proj = []
            for _ in range(factor - 1):
                cur = kern.dbl_n(cur, bits)
                proj.append(cur)
            pm = torch.stack(proj).reshape(factor - 1, 3, W, hi - lo).permute(0, 3, 1, 2)
            aff = curve.to_affine(curve.fq._cond_sub_p(pm.contiguous()))  # (f-1, B, 2, W)
            aff = aff.reshape(factor - 1, hi - lo, W2).permute(2, 0, 1)
            out.view(W2, factor, N)[:, 1:, lo:hi] = aff
    return out
