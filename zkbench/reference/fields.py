"""The prime fields the configurations name, and plain conversions between
Python ints and little-endian 32-bit words or 16-bit limbs.

The moduli are the published BLS12-381 ones (the base field Fq and the
scalar field Fr of the curve); nothing here comes from the program.
"""
from __future__ import annotations

import numpy as np

MODULI = {
    "bls12_381_fq": 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    "bls12_381_fr": 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
}


def modulus(field: str) -> int:
    return MODULI[field]


def nwords(p: int) -> int:
    """32-bit words per element: the 16-bit limbs that hold p, in pairs."""
    limbs = -(-p.bit_length() // 16)
    return (limbs + 1) // 2


def two_adic_root(p: int) -> int:
    """An element of order 2^s, s the 2-adicity of p - 1: x^((p-1)/2^s) for
    the least x >= 2 whose power has that order."""
    s, odd = 0, p - 1
    while odd % 2 == 0:
        s, odd = s + 1, odd // 2
    x = 2
    while True:
        w = pow(x, odd, p)
        if pow(w, 1 << (s - 1), p) != 1:
            return w
        x += 1


def root_of_unity(p: int, logn: int) -> int:
    """The primitive 2^logn-th root of unity the configurations' NTT uses:
    two_adic_root(p) raised to 2^(s - logn)."""
    s, odd = 0, p - 1
    while odd % 2 == 0:
        s, odd = s + 1, odd // 2
    if logn > s:
        raise ValueError(f"2-adicity {s} < {logn}")
    return pow(two_adic_root(p), 1 << (s - logn), p)


def ints_to_words(vals, W: int) -> np.ndarray:
    """Ints below 2^(32 W) -> (len, W) uint32 little-endian words."""
    raw = b"".join(int(v).to_bytes(4 * W, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(-1, W).copy()


def words_to_ints(words) -> list:
    """(k, W) 32-bit words (any integer dtype holding their bits) -> ints."""
    arr = np.ascontiguousarray(np.asarray(words).astype(np.int64) & 0xFFFFFFFF,
                               dtype="<u4")
    W = arr.shape[-1]
    raw = arr.reshape(-1, W).tobytes()
    return [int.from_bytes(raw[i:i + 4 * W], "little") for i in range(0, len(raw), 4 * W)]


def ints_to_limbs16(vals, L: int) -> np.ndarray:
    """Ints below 2^(16 L) -> (len, L) 16-bit little-endian limbs, uint16."""
    raw = b"".join(int(v).to_bytes(2 * L, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, L).copy()


def count_noncanonical(words, p: int) -> int:
    """How many rows of (n, W) int32 words (plain PyTorch, on their device)
    are not below p: compared word by word from the top, unsigned."""
    import torch

    W = words.shape[1]
    pw = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(W)]
    below = torch.zeros(words.shape[0], dtype=torch.bool, device=words.device)
    equal = torch.ones_like(below)
    for i in range(W - 1, -1, -1):
        col = words[:, i].to(torch.int64) & 0xFFFFFFFF
        below |= equal & (col < pw[i])
        equal &= col == pw[i]
    return int((~below).sum())
