"""NTT plans: the factory, NTTPlan and the four-step FourStepNTT.

Port of blaze_tpu/ntt/transform.py.  The JAX package's factory picks the
fused Pallas plan on the TPU and portable XLA plans (NTTPlan, FourStepNTT)
elsewhere.  The port has one algorithm, so every plan here runs on the
fused kernels (fused.py: K7 per level, K9 or K8 between levels), whose
plain versions run on the CPU:

  * `make_ntt` returns the fused plan, FusedNTT;
  * `NTTPlan(spec, logn)` is the fused plan of that size with the JAX
    package's form: .ntt / .intt on (..., n, W) batches, natural order;
  * `FourStepNTT(spec, logn, logn1)` is Bailey's four-step over n = n1*n2,
    A[i1, i2] = a[i1*n2 + i2]:
      1. n2 column NTTs of size n1: one batched pass of plan1's launches,
         reading the columns through their stride n2 (no transpose copy),
         writing (n1, n2) rows;
      2. the inter-pass twiddle W^(k1*i2), one K9 launch, from split
         tables T1[k1, jo] = W^(k1*jo*S), T2[k1, jl] = W^(k1*jl) (i2 =
         jo*S + jl), n1*(J + S) elements built with Field.power_matrix (K1)
         — never the n-entry W^(i*j) matrix, which the JAX package holds
         u16-compressed to fit the TPU's memory;
      3. n1 row NTTs of size n2 in one batched pass of plan2's launches,
         written as (n2, n1) rows: X[k1 + n1*k2] lands at row k2*n1 + k1,
         natural order, with no transpose.
    The inverse runs the same steps in reverse with W^-1; the sub-plans'
    inverses apply n1^-1 and n2^-1, whose product is n^-1.
    DistributedNTT (dist/ntt_dist.py) runs the same steps on one block of
    columns per rank, with the all_to_all between steps 2 and 3.

Data: (..., n, W) int32 words, Montgomery form, on the plan's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import Field
from ..fields.spec import FieldSpec, int_to_words
from .fused import FusedNTT

__all__ = ["FourStepNTT", "NTTPlan", "block_twiddles", "make_ntt"]


def make_ntt(spec: FieldSpec, logn: int, device="cuda"):
    """The fused NTT plan for (spec, logn), its tables on `device`."""
    return FusedNTT(spec, logn, device=device)


def _leading(x: torch.Tensor, n: int, W: int, device) -> None:
    if x.dtype != torch.int32 or x.dim() < 2 or tuple(x.shape[-2:]) != (n, W):
        raise ValueError(f"want (..., {n}, {W}) int32, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"input on {x.device}, plan on {device}")


class NTTPlan(FusedNTT):
    """The fused plan for one (field, logn), with the JAX package's
    signature: .ntt / .intt map (..., n, W) int32 Montgomery words, natural
    order, to a new tensor of the same shape.  A batch runs as one pass of
    the plan's launches per power-of-two piece of it (FusedNTT.ntt_batch)."""

    def __init__(self, spec: FieldSpec, logn: int, device="cuda"):
        super().__init__(spec, logn, device=device)

    def _many(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if x.dim() == 2:
            return super().intt(x) if inverse else super().ntt(x)
        n, W = self.n, self.spec.nwords
        _leading(x, n, W, self.device)
        flat = x.reshape(-1, W)
        count = flat.shape[0] // n
        outs, lo = [], 0
        for bit in reversed(range(count.bit_length())):
            if count >> bit & 1:
                piece = flat[lo * n:(lo + (1 << bit)) * n]
                outs.append(self._batch(piece, inverse, 1 << bit, 1, None, False))
                lo += 1 << bit
        return (torch.cat(outs) if outs else flat.clone()).reshape(x.shape)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT over the last two dimensions (n, W)."""
        return self._many(x, False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT over the last two dimensions (n, W)."""
        return self._many(x, True)


def block_twiddles(field: Field, w: int, n1: int, j_off: int, ncols: int, device):
    """Split tables of W^(i*(j_off + j)), i < n1, j < ncols (a power of two),
    w the root W: T1 (n1, J, W) = W^(i*(j_off + jo*S)) and T2 (n1, S, W) =
    W^(i*jl), S = 2^ceil(log2(ncols)/2), J = ncols/S, Montgomery words.  K9
    multiplies element (i, j = jo*S + jl) by T1[i, jo] * T2[i, jl]."""
    spec = field.spec
    p = spec.p
    logc = ncols.bit_length() - 1
    S = 1 << (logc + 1) // 2
    J = ncols // S

    def mont(v: int) -> torch.Tensor:
        return torch.as_tensor(int_to_words(v * spec.r % p, spec.nwords).view(np.int32),
                               device=device)

    shift = field.powers(mont(pow(w, j_off, p)), n1)                  # W^(i*j_off)
    t1 = field.power_matrix(field.powers(mont(pow(w, S, p)), n1), J)  # W^(i*jo*S)
    t1 = field.mul(t1, shift[:, None])
    t2 = field.power_matrix(field.powers(mont(w), n1), S)             # W^(i*jl)
    return t1.contiguous(), t2.contiguous()


class FourStepNTT:
    """Bailey four-step NTT plan for one (field, logn), n = n1 * n2 with n1 =
    2^logn1 (default logn // 2): .ntt / .intt map (..., n, W) int32
    Montgomery words, natural order, to a new tensor of the same shape (a
    batch runs one vector at a time).  The steps are the module docstring's;
    DistributedNTT runs them on one block of columns per rank."""

    def __init__(self, spec: FieldSpec, logn: int, logn1: int | None = None, device="cuda"):
        self._setup(spec, logn, logn1, device, ndev=1, rank=0)

    def _setup(self, spec, logn, logn1, device, ndev: int, rank: int) -> None:
        """Plans and tables for the columns [rank*n2/ndev, (rank+1)*n2/ndev)."""
        if logn > spec.two_adicity:
            raise ValueError(f"{spec.name}: 2-adicity {spec.two_adicity} < logn {logn}")
        self.spec = spec
        self.field = Field(spec)
        self.logn = logn
        self.logn1 = logn // 2 if logn1 is None else logn1
        if not 0 <= self.logn1 <= logn:
            raise ValueError(f"logn1 {self.logn1} outside [0, {logn}]")
        self.logn2 = logn - self.logn1
        self.n = 1 << logn
        self.n1, self.n2 = 1 << self.logn1, 1 << self.logn2
        if self.n1 % ndev or self.n2 % ndev:
            raise ValueError(f"n1={self.n1}, n2={self.n2} must divide by {ndev} ranks")
        self.ndev, self.rank = ndev, rank
        self.ncols = self.n2 // ndev                  # this rank's columns i2
        self.j_off = rank * self.ncols
        self.device = torch.device(device)
        self.plan1 = FusedNTT(spec, self.logn1, device=self.device)
        self.plan2 = FusedNTT(spec, self.logn2, device=self.device)
        p = spec.p
        w = spec.root_of_unity(logn)
        self._tw = {inv: block_twiddles(self.field, pow(w, -1, p) if inv else w, self.n1,
                                        self.j_off, self.ncols, self.device)
                    for inv in (False, True)}

    # -------------------------------------------------------------- steps
    def _twiddle(self, y: torch.Tensor, inverse: bool) -> torch.Tensor:
        """(n1, ncols) rows: element (k1, j) times W^(+-k1*(j_off + j)), in
        place, one K9 launch on this rank's tables."""
        t1, t2 = self._tw[inverse]
        logc = self.ncols.bit_length() - 1
        fields = ((0, logc, 0),) if logc else ()
        return self.plan1.kern.twiddle_mul(y, t1, t2, logc, fields, out=y)

    def _fwd_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Steps 1-2 on this rank's columns of x ((n, W) natural order): the
        column NTTs and the twiddle, as (n1, ncols) rows, k1 major."""
        y = self.plan1.ntt_batch(x[self.j_off:], self.ncols, stride=self.n2, batch_stride=1,
                                 minor=True)
        return self._twiddle(y, False)

    def _inv_cols(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse of `_fwd_cols` on (n1, ncols) rows, k1 major (the twiddle
        in place): this rank's columns of the input, (n1, ncols) rows."""
        self._twiddle(y, True)
        return self.plan1.intt_batch(y, self.ncols, stride=self.ncols, batch_stride=1,
                                     minor=True)

    def _ntt1(self, x: torch.Tensor) -> torch.Tensor:
        return self.plan2.ntt_batch(self._fwd_cols(x), self.n1, minor=True)

    def _intt1(self, X: torch.Tensor) -> torch.Tensor:
        # X[k1 + n1*k2] at row k2*n1 + k1: row transform k1 at stride n1
        y = self.plan2.intt_batch(X, self.n1, stride=self.n1, batch_stride=1)
        return self._inv_cols(y)

    def _each(self, x: torch.Tensor, one) -> torch.Tensor:
        W = self.spec.nwords
        _leading(x, self.n, W, self.device)
        if x.dim() == 2:
            return one(x.contiguous())
        flat = x.reshape(-1, self.n, W)
        return torch.stack([one(v.contiguous()) for v in flat]).reshape(x.shape)

    # ------------------------------------------------------------- public
    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT over the last two dimensions (n, W)."""
        return self._each(x, self._ntt1)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT over the last two dimensions (n, W)."""
        return self._each(x, self._intt1)
