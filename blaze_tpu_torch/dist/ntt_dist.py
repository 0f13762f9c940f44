"""Sharded four-step NTT: local sub-NTTs and an all_to_all between them.

Port of blaze_tpu/dist/ntt_dist.py, the replacement for the reference's
16-HBM-bank scatter/gather shuffle (`blaze/src/ingo_ntt/ntt_data.rs:80-156`,
a within-card host all-to-all): the coefficient matrix is sharded over one
mesh axis and the inter-pass transpose is an `all_to_all_single` over that
axis's process group (NCCL between cards, gloo on the CPU).

Decomposition (n = n1 * n2, A[i1, i2] = a[i1*n2 + i2], D ranks on the axis,
rank d owning the columns i2 in [d*n2/D, (d+1)*n2/D)):
  1. column NTTs (size n1) over the rank's n2/D columns, read through their
     stride n2 in one batched pass of the sub-plan's launches (K7, K9);
  2. the twiddle W^(k1*(j_off + j)) on K9 from this rank's own split tables
     (FourStepNTT's T1 with the rank's column offset j_off = d*n2/D folded
     in): n1*(J + S) elements each way, built on the rank that uses them,
     so no twiddle byte crosses ranks (the JAX package generates its
     W^(i*j) block per device for the same reason);
  3. all_to_all: i2-sharded -> k1-sharded;
  4. row NTTs (size n2) over the rank's n1/D rows, one batched pass.
The inverse runs the same steps in reverse order with W^-1.  At D = 1 the
exchanges are the identity and are skipped (no 4 GiB receive buffer at
2^27 on one card); at D > 1 each is one collective and one local copy that
puts the received blocks in row order.

Left out: the JAX package's platform switch (`portable_only` on non-TPU
meshes) and the u16-compressed twiddle matrix, both TPU workarounds.
"""
from __future__ import annotations

import torch

from ..fields.spec import FieldSpec
from ..ntt.transform import FourStepNTT
from .mesh import all_gather, all_to_all, mesh_axis, mesh_device

__all__ = ["DistributedNTT"]


class DistributedNTT(FourStepNTT):
    """Four-step NTT sharded over one axis of a DeviceMesh; every rank of the
    axis constructs it and calls each method (they are collective)."""

    def __init__(self, spec: FieldSpec, logn: int, mesh, axis: str = "sp",
                 logn1: int | None = None):
        self.mesh = mesh
        self.axis = axis
        self.group, ndev, rank = mesh_axis(mesh, axis)
        self._setup(spec, logn, logn1, mesh_device(mesh), ndev, rank)

    def _shard_shape(self) -> tuple:
        return (self.n1 // self.ndev, self.n2, self.spec.nwords)

    def _check_shard(self, xk: torch.Tensor) -> None:
        if xk.dtype != torch.int32 or tuple(xk.shape) != self._shard_shape():
            raise ValueError(f"want this rank's ({', '.join(map(str, self._shard_shape()))}) "
                             f"int32 k-matrix shard, got {tuple(xk.shape)} {xk.dtype}")
        if xk.device != self.device:
            raise ValueError(f"input on {xk.device}, plan on {self.device}")

    # ------------------------------------------------------------- public
    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, W) Montgomery words, natural order, the whole vector on
        every rank (each reads only its own columns, through their stride).
        Returns this rank's k1-shard of the spectral (n1, n2) k-matrix:
        (n1/D, n2, W) with out[k1 - rank*n1/D, k2] = X[k1 + n1*k2]."""
        W, D = self.spec.nwords, self.ndev
        if x.dtype != torch.int32 or tuple(x.shape) != (self.n, W):
            raise ValueError(f"want ({self.n}, {W}) int32, got {tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, plan on {self.device}")
        y = self._fwd_cols(x.contiguous())                 # (n1, n2/D) rows, k1 major
        rows = self.n1 // D
        if D > 1:
            # block e of k1 to rank e; block e received is columns e*n2/D..
            y = all_to_all(y, self.group).view(D, rows, self.ncols, W)
            y = y.transpose(0, 1).reshape(-1, W)           # (n1/D, n2) rows
        return self.plan2.ntt_batch(y, rows).view(self._shard_shape())

    def intt(self, xk: torch.Tensor) -> torch.Tensor:
        """Inverse of ntt(): this rank's (n1/D, n2, W) k-matrix shard -> the
        (n, W) natural-order vector, gathered on every rank."""
        self._check_shard(xk)
        W, D = self.spec.nwords, self.ndev
        rows = self.n1 // D
        y = self.plan2.intt_batch(xk.reshape(-1, W), rows)  # (n1/D, n2) rows, i2 natural
        if D > 1:
            y = y.view(rows, D, self.ncols, W).transpose(0, 1).contiguous()
            y = all_to_all(y, self.group).view(-1, W)       # (n1, n2/D) rows, k1 major
        a = self._inv_cols(y)                              # (n1, n2/D) rows, i1 major
        if D > 1:
            g = all_gather(a.view(self.n1, self.ncols, W), self.group, D)
            a = g.transpose(0, 1).reshape(-1, W)           # (n1, n2) rows: natural
        return a

    def _natural(self, xk: torch.Tensor, count: int) -> torch.Tensor:
        """The first `count` spectral values X[k], natural order, on every
        rank: the k-matrix columns k2 < ceil(count / n1), gathered."""
        self._check_shard(xk)
        W = self.spec.nwords
        part = xk[:, :-(-count // self.n1)]               # (n1/D, cols, W)
        if self.ndev > 1:
            part = all_gather(part, self.group, self.ndev).reshape(self.n1, -1, W)
        # X[k1 + n1*k2] to row k2*n1 + k1
        return part.transpose(0, 1).reshape(-1, W)[:count]

    def spectral_to_natural(self, xk: torch.Tensor) -> torch.Tensor:
        """This rank's k-matrix shard -> the natural-order (n, W) vector X[k],
        gathered on every rank."""
        return self._natural(xk, self.n)
