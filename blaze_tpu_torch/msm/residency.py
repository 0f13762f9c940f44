"""Device-resident MSM operand layouts.

The reference keeps bases resident in card HBM and reuses them across MSM
calls with scalars-only set_data (`blaze/src/ingo_msm/
msm_api.rs:144-153,299-322`).  The port's resident layout is word-major:

    resident[k, n]     = X word k of P_n      k < W        (2W, N) int32
    resident[W + k, n] = Y word k of P_n

Montgomery affine coordinates, one point per column.  The scan kernel (K2)
runs one thread per lane and reads one row per word, so neighbouring threads
read neighbouring words; the sort's gather moves whole columns.  A point
takes 2 * 4W bytes, as in the JAX package's xy-packed (L, N) u32 layout
(16-bit limbs r of X and Y in one word), which `from_reference_resident` /
`to_reference_resident` convert from and to.  Scalars are resident as
(Ls, N) int32 16-bit limbs, the layout the digit extraction reads.
"""
from __future__ import annotations

import numpy as np
import torch

from ..curves.ops import Curve


def points_to_resident(curve: Curve, points: torch.Tensor, mont: bool = False):
    """(N, 2, W) int32 affine words (canonical, or Montgomery when mont=True)
    -> (2W, N) int32 Montgomery residency."""
    m = points if mont else curve.fq.to_mont(points)
    return m.reshape(m.shape[0], -1).t().contiguous()


def points_from_resident(curve: Curve, resident: torch.Tensor) -> torch.Tensor:
    """(2W, N) residency -> (N, 2, W) int32 Montgomery affine."""
    return resident.t().reshape(-1, 2, curve.nwords)


def scalars_to_resident(scalars: torch.Tensor) -> torch.Tensor:
    """(N, Ls) 16-bit limbs -> (Ls, N) int32 lanes-major."""
    return scalars.to(torch.int32).t().contiguous()


def from_reference_resident(arr: np.ndarray, curve: Curve, device="cpu"):
    """The JAX package's (L, N) u32 xy-packed Montgomery residency
    (limb r of X in the low half of row r, limb r of Y in the high half)
    -> the port's (2W, N) int32 residency."""
    a = np.asarray(arr, dtype=np.uint32)
    x16 = (a & 0xFFFF).astype(np.uint32)
    y16 = a >> 16
    xw = x16[0::2] | (x16[1::2] << 16)
    yw = y16[0::2] | (y16[1::2] << 16)
    out = np.ascontiguousarray(np.concatenate([xw, yw], axis=0))
    return torch.as_tensor(out.view(np.int32), device=device)


def to_reference_resident(resident: torch.Tensor, curve: Curve) -> np.ndarray:
    """The port's (2W, N) residency -> the JAX package's (L, N) u32
    xy-packed layout."""
    W = curve.nwords
    w = resident.cpu().numpy().view(np.uint32)
    xw, yw = w[:W], w[W:]
    x16 = np.stack([xw & 0xFFFF, xw >> 16], axis=1).reshape(2 * W, -1)
    y16 = np.stack([yw & 0xFFFF, yw >> 16], axis=1).reshape(2 * W, -1)
    return (x16 | (y16 << 16)).astype(np.uint32)
