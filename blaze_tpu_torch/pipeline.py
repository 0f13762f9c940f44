"""Proof-generation pipeline: NTT -> MSM, two batches in flight.

Port of blaze_tpu/pipeline.py, BASELINE config 5 ("NTT 2^27 + MSM 2^24
proof-gen pipeline"): the flow a proving system runs — polynomial
evaluation by NTT, then a multi-scalar multiplication whose scalars are the
spectral values.  The reference pipelines one primitive against host I/O
with two device buffers (`integration_ntt.rs:103-136`); here, as in the JAX
package, the 2-deep pipeline runs across the two primitives.  Batch k+1's
NTT is queued on a side CUDA stream before batch k's MSM is queued on the
caller's current stream; an event orders each MSM after its own NTT, and
the two streams' tensors are handed over with `record_stream`, so the
caching allocator reuses none of them early.

On a mesh (`mesh=`, a DeviceMesh from dist.make_mesh) the pipeline runs
`run_dist`: DistributedNTT (the four-step, all_to_all between its passes)
on the `ntt_axis`, the first 2^msm_logn spectral values in natural order,
their canonical form (from_mont, K1) as the scalars, and DistributedMSM
(per-rank chunks, all_gather of the window sums, K3 tree reduce, K6 fold)
on the `msm_axis`.  Not ported: the TPU's blocked u16 NTT layout and its
relayout (`_spectral_to_scalars_blocked`); the port's NTT keeps (n, W)
int32 words, and the scalars are their 16-bit halves.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .curves.ops import Curve
from .fields.mont import Field
from .fields.spec import FieldSpec
from .msm import MSM, MSMConfig
from .ntt import make_ntt
from .oracle import ECOracle
from .runtime.device import DeviceContext
from .utils.errors import DataError

__all__ = ["ProofPipeline", "geometric_msm_oracle"]


class ProofPipeline:
    """NTT(coeffs) -> scalars -> MSM(points, scalars) for one curve.

    curve.spec.fr is the NTT field.  `msm_logn` <= `ntt_logn`: the first
    2^msm_logn spectral values become the MSM scalars (a proving system
    commits to evaluation-form polynomials).  The plan (FusedNTT) and the
    MSM run on the context's device: the card by default, where a missing
    card raises; `device="cpu"` runs the kernels' plain versions.  With a
    `mesh` (a DeviceMesh; its device type picks the device) the pipeline
    runs `run_dist` on DistributedNTT (`ntt_axis`) and DistributedMSM
    (`msm_axis`) instead of `run_batches`.
    """

    def __init__(self, curve: Curve, ntt_logn: int, msm_logn: int, mesh=None,
                 msm_axis: str = "dp", ntt_axis: str = "sp",
                 config: MSMConfig | None = None, ctx: Optional[DeviceContext] = None,
                 device: Optional[str] = None):
        if not 0 <= msm_logn <= ntt_logn:
            raise ValueError("msm_logn must be <= ntt_logn")
        self.curve = curve
        self.fr: FieldSpec = curve.spec.fr
        self.ntt_logn = ntt_logn
        self.msm_logn = msm_logn
        self.mesh = mesh
        self.plan = self.msm = self.dntt = self.dmsm = self._side = None
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from .dist import DistributedMSM, DistributedNTT
            from .dist.mesh import mesh_device

            if not isinstance(mesh, DeviceMesh):
                raise ValueError(f"mesh: want a torch DeviceMesh (dist.make_mesh), got "
                                 f"{type(mesh).__name__}")
            dev = mesh_device(mesh)
            self.ctx = ctx or DeviceContext(device_id=dev.index or 0, device=dev.type)
            if self.ctx.device != dev:
                raise ValueError(f"context on {self.ctx.device}, mesh on {dev}")
            self.dntt = DistributedNTT(self.fr, ntt_logn, mesh, axis=ntt_axis)
            self.dmsm = DistributedMSM(curve, mesh, axis=msm_axis, config=config)
            self._fr = Field(self.fr)
            return
        self.ctx = ctx or DeviceContext(device=device)
        self.plan = make_ntt(self.fr, ntt_logn, device=self.ctx.device)
        self.msm = MSM(curve, config)
        self._side = (torch.cuda.Stream(self.ctx.device)
                      if self.ctx.device.type == "cuda" else None)

    # ------------------------------------------------------------ inputs
    def _check_coeffs(self, coeffs) -> None:
        """A batch is (2^n, W) int32 words or the reference's unblocked
        (2^n, L) 16-bit limbs (L = 2W, int32 or int64) on the pipeline's
        device; any other shape, type or device raises DataError."""
        n, W = 1 << self.ntt_logn, self.fr.nwords
        if not isinstance(coeffs, torch.Tensor) or coeffs.dim() != 2 \
                or coeffs.shape[0] != n or coeffs.shape[1] not in (W, 2 * W):
            got = tuple(coeffs.shape) if isinstance(coeffs, torch.Tensor) else type(coeffs)
            raise DataError(f"coefficients: want ({n}, {2 * W}) 16-bit limbs or "
                            f"({n}, {W}) int32 words, got {got}")
        if coeffs.device != self.ctx.device:
            raise DataError(f"coefficients on {coeffs.device}, pipeline on "
                            f"{self.ctx.device}")
        if coeffs.shape[1] == W and coeffs.dtype != torch.int32:
            raise DataError(f"coefficient words: want int32, got {coeffs.dtype}")
        if coeffs.dtype not in (torch.int32, torch.int64):
            raise DataError(f"coefficient limbs: want int32 or int64, got {coeffs.dtype}")

    def _coeff_words(self, coeffs) -> torch.Tensor:
        """One checked batch of canonical coefficients -> (2^n, W) int32
        words: words pass as they are, limbs are checked to lie below 2^16
        (one wait for the device) and paired into words on the device."""
        self._check_coeffs(coeffs)
        if coeffs.shape[1] == self.fr.nwords:
            return coeffs.contiguous()
        if bool(((coeffs < 0) | (coeffs > 0xFFFF)).any()):
            raise DataError("coefficients: a 16-bit limb is out of range")
        # int16 keeps each limb's 16 bits; two of them, low first, are a word
        return coeffs.to(torch.int16).contiguous().view(torch.int32)

    def _check_points(self, points: torch.Tensor) -> None:
        want = (2 * self.curve.nwords, 1 << self.msm_logn)
        if not isinstance(points, torch.Tensor) or tuple(points.shape) != want \
                or points.dtype != torch.int32 or points.device != self.ctx.device:
            got = ((tuple(points.shape), points.dtype, points.device)
                   if isinstance(points, torch.Tensor) else type(points))
            raise DataError(f"points: want the {want} int32 residency on "
                            f"{self.ctx.device}, got {got}")

    # ----------------------------------------------------------- scalars
    def _spectral_scalars(self, y: torch.Tensor) -> torch.Tensor:
        """(2^n, W) canonical spectral words -> the first 2^m values as
        (Ls, 2^m) int32 16-bit limbs, the MSM's resident scalar layout: the
        words' int16 halves, transposed, widened and masked (two device
        operations)."""
        m = 1 << self.msm_logn
        halves = y[:m].view(torch.int16)                    # (m, Ls), low half first
        out = torch.empty((halves.shape[1], m), dtype=torch.int32, device=y.device)
        out.copy_(halves.t())                               # sign-extends each half
        return out.bitwise_and_(0xFFFF)

    def scalars(self, coeffs) -> torch.Tensor:
        """The MSM scalars of one coefficient batch: the first 2^m values of
        its NTT, as (Ls, 2^m) int32 canonical 16-bit limbs, queued on the
        current stream.  The NTT of canonical coefficients is canonical: the
        transform is linear and the plan's twiddles are Montgomery
        representatives, so representatives go to representatives
        (NTTClient)."""
        if self.plan is None:
            raise ValueError("a mesh pipeline runs run_dist")
        return self._spectral_scalars(self.plan.ntt(self._coeff_words(coeffs)))

    def _queue_ntt(self, coeffs):
        """Queue one batch's NTT and scalars; returns (scalars, the event its
        MSM waits for, None on the CPU).  On the card the work goes on the
        side stream, after what the caller's stream has queued (the batch
        may be made there); the 2^n spectral buffer (4 GiB at 2^27) is
        dropped as soon as the scalars are queued."""
        if self._side is None:
            return self.scalars(coeffs), None
        self._check_coeffs(coeffs)                 # before any work is queued
        self._side.wait_stream(torch.cuda.current_stream(self.ctx.device))
        with torch.cuda.stream(self._side):
            scal = self.scalars(coeffs)
            done = torch.cuda.Event()
            done.record(self._side)
        # the caller may drop the batch while the side stream still reads it
        coeffs.record_stream(self._side)
        return scal, done

    # ---------------------------------------------------------- pipeline
    def run_batches(self, coeff_batches, points_resident: torch.Tensor,
                    window_bits: int | None = None):
        """The 2-deep cross-primitive pipeline.

        coeff_batches: an iterable of canonical coefficient batches, each
        (2^n, W) int32 words or (2^n, L) 16-bit limbs on the pipeline's
        device.  points_resident: the (2W, 2^m) int32 Montgomery residency
        of 2^m bases (msm/residency.py).  Yields one (3, W) projective
        Montgomery MSM result per batch, in batch order, once it is
        computed.  Batch k+1's NTT is queued before batch k's MSM, so on the
        card it runs while the host queues that MSM.  On a CUDA tensor every
        step runs on the card or raises."""
        if self.plan is None:
            raise ValueError("a mesh pipeline runs run_dist")
        self._check_points(points_resident)
        batches = iter(coeff_batches)
        coeffs = next(batches, None)
        queued = None if coeffs is None else self._queue_ntt(coeffs)
        while queued is not None:
            scal, ntt_done = queued
            coeffs = next(batches, None)
            queued = None if coeffs is None else self._queue_ntt(coeffs)
            del coeffs
            if ntt_done is not None:
                stream = torch.cuda.current_stream(self.ctx.device)
                stream.wait_event(ntt_done)
                scal.record_stream(stream)
            res = self.msm(points_resident, scal, window_bits=window_bits)
            del scal
            if ntt_done is not None:
                msm_done = torch.cuda.Event()
                msm_done.record(stream)
                msm_done.synchronize()
            yield res

    # ------------------------------------------------------- distributed
    def run_dist(self, coeffs, points, window_bits: int | None = None,
                 scalar_bits: int | None = None, scalar_mask=None) -> torch.Tensor:
        """The mesh path: the sharded NTT (all_to_all between its passes)
        feeding the dp-sharded MSM; every rank calls it with the whole
        input and gets the (3, W) projective Montgomery result.

        coeffs: (2^n, W) int32 Montgomery words (or the reference's (2^n, L)
        16-bit limbs) on the mesh's device.  points: the 2^m affine
        Montgomery bases, (2^m, 2, W) words or the (2W, 2^m) residency.
        The first 2^m spectral values, natural order, are Montgomery here
        (the sharded NTT keeps the form): from_mont (K1) makes them the
        canonical scalars.  scalar_mask, Ls per-limb bit masks (e.g. [0xFF,
        0, ...] keeps 8 scalar bits), truncates them for short dry runs."""
        if self.dntt is None:
            raise ValueError("no mesh: use run_batches")
        x = self._coeff_words(coeffs)
        y = self.dntt._natural(self.dntt.ntt(x), 1 << self.msm_logn)   # (2^m, W)
        scal = self._spectral_scalars(self._fr.from_mont(y))            # (Ls, 2^m)
        if scalar_mask is not None:
            mask = torch.as_tensor(np.asarray(scalar_mask, dtype=np.int64), device=scal.device)
            if mask.shape != (scal.shape[0],):
                raise DataError(f"scalar_mask: want {scal.shape[0]} per-limb masks, got "
                                f"{tuple(mask.shape)}")
            scal &= mask.to(scal.dtype)[:, None]
        if points.dim() == 3:
            scal = scal.t()
        return self.dmsm(points, scal, window_bits=window_bits, scalar_bits=scalar_bits)


def geometric_msm_oracle(curve_spec, npoints_unique: int, n: int, w: int, base_points):
    """Expected MSM for scalars s_i = w^i (i < n) over period-tiled points.

    Point i is base_points[i % U], U = npoints_unique (the reference's own
    large-size test trick, tests/msm/mod.rs:23-31), so the coefficient of
    base point j is the closed-form geometric sum

        c_j = w^j * (w^(U*M) - 1) / (w^U - 1)  mod r,  M = n / U,

    and a 2^24-point pipeline result is checked by a U-point host MSM.
    Returns the affine expected point (None for the identity).

    The coefficients are reduced mod r, which is right only where r kills
    every base point: the base points must lie in the order-r subgroup
    (ECOracle.random_subgroup_point).  ECOracle.random_point's BLS12-381
    points lie outside it, and there the closed form is wrong."""
    r = curve_spec.fr.p
    U = npoints_unique
    M = n // U
    if U * M != n:
        raise ValueError(f"{n} points are not a whole number of periods of {U}")
    num = (pow(w, U * M, r) - 1) % r
    den = (pow(w, U, r) - 1) % r
    ratio = num * pow(den, -1, r) % r
    coeffs = [pow(w, j, r) * ratio % r for j in range(U)]
    return ECOracle(curve_spec).msm(base_points, coeffs)
