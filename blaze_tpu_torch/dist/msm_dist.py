"""Data-parallel MSM over one axis of a device mesh.

Port of blaze_tpu/dist/msm_dist.py.  Points and scalars are split over the
axis ('dp'); each rank runs the port's chunked Pippenger on its rows (the
per-card task of the reference, which has no multi-card story): the
engine's chunk loop (MSM.window_sums: per chunk of its planned points the
window sums, added across chunks on K3).  The (nwin, 3, W) window sums, a
few KB, are then gathered from every rank (`all_gather_single`), reduced
by a log-depth tree of batched complete adds on K3, and folded on K6
(MSM.finalize).  Every rank computes the same reduction of the same
gathered sums, so the result is replicated.  Communication is O(nwin)
points: the reduce-side analog of the reference's final-accumulation phase
(msm_hw_code.rs:27,33-34).

Left out: the JAX package's `fused` switch (the port has one algorithm),
its platform switch (`portable_only` on non-TPU meshes) and its
`lax.scan` over the chunks (a Python loop re-dispatches one chunk's kernels
here, as the single-card MSM does).
"""
from __future__ import annotations

import torch

from ..curves.ops import Curve
from ..msm.pippenger import MSM, MSMConfig, default_window_bits
from ..msm.residency import points_to_resident, scalars_to_resident
from .mesh import all_gather, mesh_axis

__all__ = ["DistributedMSM"]


class DistributedMSM:
    """MSM sharded over a mesh axis.  Every rank of the mesh calls it with
    the whole (globally shaped) input; each reads its own block of rows."""

    def __init__(self, curve: Curve, mesh, axis: str = "dp",
                 config: MSMConfig | None = None):
        self.curve = curve
        self.mesh = mesh
        self.axis = axis
        self.group, self.ndev, self.rank = mesh_axis(mesh, axis)
        self.engine = MSM(curve, config)

    def _reduce_wsums(self, gathered: torch.Tensor) -> torch.Tensor:
        """(D, nwin, 3, W) -> (nwin, 3, W) by log-depth batched EC adds, one
        K3 launch per level (none at D = 1)."""
        nwin, W = gathered.shape[1], self.curve.nwords
        while gathered.shape[0] > 1:
            d = gathered.shape[0]
            half = d // 2
            merged = self.engine.accumulate(gathered[:half].reshape(-1, 3, W),
                                            gathered[half:2 * half].reshape(-1, 3, W))
            merged = merged.view(half, nwin, 3, W)
            if d % 2:
                merged = torch.cat([merged, gathered[2 * half:]])
            gathered = merged
        return gathered[0]

    def __call__(self, points, scalars, window_bits: int | None = None,
                 scalar_bits: int | None = None) -> torch.Tensor:
        """MSM of Montgomery affine points — (N, 2, W) points-major or
        (2W, N) resident words — with canonical scalar limbs, (N, Ls) or
        (Ls, N) (the layout follows the points', as in MSM.__call__), the
        whole input on every rank.  Returns the (3, W) projective
        Montgomery result on every rank.  N must divide by the axis's size
        D; window_bits defaults to min(config.window_bits,
        default_window_bits(N // D)); scalar_bits limits the windows to the
        scalars' low bits."""
        resident = points.dim() == 2
        n = points.shape[1] if resident else points.shape[0]
        D = self.ndev
        if n % D:
            raise ValueError(f"n={n} not divisible by mesh axis {self.axis}={D}")
        eng = self.engine
        c = window_bits or min(eng.config.window_bits, default_window_bits(n // D))
        per = n // D
        lo = self.rank * per
        if resident:
            pts, scal = points[:, lo:lo + per], scalars[:, lo:lo + per]
        else:
            pts = points_to_resident(self.curve, points[lo:lo + per], mont=True)
            scal = scalars_to_resident(scalars[lo:lo + per])
        wsums = eng.window_sums(pts, scal, c, scalar_bits)
        gathered = all_gather(wsums, self.group, D)       # (D, nwin, 3, W)
        return eng.finalize(self._reduce_wsums(gathered), c)
