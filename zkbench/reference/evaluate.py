"""Exact evaluation of a long vector as a polynomial, sum_i v_i z^i mod p,
at a few points z, in plain PyTorch on the vector's device.

An NTT's output k is the input's polynomial at w^k; and, read the other
way, sum_k y_k w^(-ik) = n x_i, so evaluating the output at w^(-i) checks
every output element at once (a wrong y_k shifts the sum by its error
times w^(-ik), never 0).  Both are this function.

With i = a B + b (B = 2^ceil(logn / 2), A = n / B):

    sum_i v_i z^i = sum_a (z^B)^a S_a,    S_a = sum_b v_(aB+b) z^b.

Both sums run as float64 matrix products on 16-bit limbs, whose every
partial sum is an integer below 2^53 and so exact: S_a's are
(A 16, B) x (B, K 16) with terms below 2^32 and B <= 2^21; the outer sum
is (K, S, A) x (K, A, 16) with digits below 2^16 and A <= 2^21.  The
powers of z are Python ints; the last carries are Python ints too.
"""
from __future__ import annotations

import numpy as np
import torch

from .fields import ints_to_limbs16

ROWS_PER_BLOCK = 1 << 24       # elements of v converted to float64 at a time


def _limbs16(words: torch.Tensor) -> torch.Tensor:
    """(m, W) int32 words -> (m, 2W) int32 16-bit limbs, little-endian."""
    lo = words & 0xFFFF
    hi = (words >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(words.shape[0], -1)


def _power_limbs(zs: list, count: int, p: int, L: int, device) -> torch.Tensor:
    """(count, K, L) float64 limbs of z^j mod p, j < count, for each z."""
    cols = []
    for z in zs:
        acc, row = 1, []
        for _ in range(count):
            row.append(acc)
            acc = acc * z % p
        cols.append(ints_to_limbs16(row, L))
    out = np.stack(cols, axis=1).astype(np.float64)
    return torch.from_numpy(out).to(device)


def evaluate(v: torch.Tensor, zs: list, p: int) -> list:
    """[sum_i v_i z^i mod p for z in zs] for (n, W) int32 words v (each a
    little-endian integer below 2^(32 W)), n a power of two."""
    n, W = v.shape
    logn = n.bit_length() - 1
    if n != 1 << logn:
        raise ValueError(f"length {n} is not a power of two")
    L, K = 2 * W, len(zs)
    B = 1 << ((logn + 1) // 2)
    A = n // B
    dev = v.device
    zb = [pow(z, B, p) for z in zs]
    inner = _power_limbs(zs, B, p, L, dev).reshape(B, K * L)        # z^b
    outer = _power_limbs(zb, A, p, L, dev)                            # (z^B)^a
    S = 2 * L - 1 + 4                       # digits of S_a, with room for carries
    digits = torch.zeros((A, K, S), dtype=torch.int64, device=dev)
    rows = max(1, min(A, ROWS_PER_BLOCK // B))
    for a0 in range(0, A, rows):
        a1 = min(A, a0 + rows)
        blk = _limbs16(v[a0 * B:a1 * B]).reshape(a1 - a0, B, L)
        blk = blk.permute(0, 2, 1).to(torch.float64).reshape(-1, B)  # (a l, b)
        part = (blk @ inner).reshape(a1 - a0, L, K, L)                # exact, < 2^46
        del blk
        diag = torch.zeros((a1 - a0, K, S), dtype=torch.float64, device=dev)
        for l in range(L):
            diag[:, :, l:l + L] += part[:, l]                         # < 2^50
        digits[a0:a1] = diag.to(torch.int64)
    for s in range(S - 1):                                            # carries
        digits[:, :, s + 1] += digits[:, :, s] >> 16
        digits[:, :, s] &= 0xFFFF
    if int(digits[:, :, S - 1].max()) >> 16:
        raise AssertionError("evaluate: a sum overflowed its digits")
    prod = torch.bmm(digits.permute(1, 2, 0).to(torch.float64),     # (K, S, A)
                     outer.permute(1, 0, 2))                          # (K, A, L)
    prod = prod.cpu().numpy()
    out = []
    for k in range(K):
        acc = 0
        for s in range(S):
            for j in range(L):
                acc += int(prod[k, s, j]) << (16 * (s + j))
        out.append(acc % p)
    return out
