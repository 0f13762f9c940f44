from .codec import (
    bank_merge,
    bank_split,
    bytes_to_limbs,
    have_native,
    limbs_to_bytes,
    transpose,
)

__all__ = [
    "have_native",
    "bytes_to_limbs",
    "limbs_to_bytes",
    "bank_split",
    "bank_merge",
    "transpose",
]
