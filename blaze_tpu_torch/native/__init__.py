from .codec import bank_merge, bank_split, bytes_to_limbs, limbs_to_bytes, transpose

__all__ = [
    "bytes_to_limbs",
    "limbs_to_bytes",
    "bank_split",
    "bank_merge",
    "transpose",
]
