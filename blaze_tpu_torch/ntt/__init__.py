from .transform import make_ntt
from .fused import FusedNTT, split_parts, tables_from_reference
from .kernels import NTTKernels

__all__ = [
    "FusedNTT",
    "NTTKernels",
    "make_ntt",
    "split_parts",
    "tables_from_reference",
]
