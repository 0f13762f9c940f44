from .transform import FourStepNTT, NTTPlan, make_ntt
from .fused import FusedNTT, split_parts, tables_from_reference
from .kernels import NTTKernels

__all__ = [
    "FourStepNTT",
    "FusedNTT",
    "NTTKernels",
    "NTTPlan",
    "make_ntt",
    "split_parts",
    "tables_from_reference",
]
