"""NTT plan factory and the bit-reversal permutation.

The JAX package's factory (blaze_tpu/ntt/transform.py make_ntt) picks the
fused Pallas plan on the TPU and a portable XLA plan (NTTPlan, FourStepNTT)
elsewhere.  The port has one algorithm: `make_ntt` always returns the fused
plan (fused.py), whose kernels run on the card and whose plain versions run
on the CPU.
"""
from __future__ import annotations

import numpy as np

from ..fields.spec import FieldSpec


def _bitrev_perm(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def make_ntt(spec: FieldSpec, logn: int, device="cuda"):
    """The fused NTT plan for (spec, logn), its tables on `device`."""
    from .fused import FusedNTT

    return FusedNTT(spec, logn, device=device)
