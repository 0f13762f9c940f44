"""Montgomery field arithmetic on torch tensors of 32-bit words.

All ops act on `int32[..., W]` tensors (little-endian uint32 words, value
< p, Montgomery form) and are elementwise over every leading batch
dimension.  `mul` is the K1 kernel (fields/montmul.py); add/sub/neg are
plain torch ops on int64 copies of the words with carry-lookahead
(fields/kernel_ops.py), as the JAX package's were XLA ops.  Every op keeps
the canonical < p invariant, so results equal blaze_tpu's Field bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel_ops import cond_sub, normalize, sub_limbs, words_i32, words_u64
from .montmul import mont_mul
from .spec import FieldSpec, int_to_words, words_to_int


class Field:
    """Batched field ops bound to one FieldSpec. Stateless apart from
    per-device constant caches."""

    def __init__(self, spec: FieldSpec):
        if not spec.r > spec.p:
            raise ValueError("Montgomery radix must exceed the modulus")
        self.spec = spec
        self.nwords = spec.nwords
        self._consts: dict = {}

    def const(self, value: int, device, wide: bool = False) -> torch.Tensor:
        """(W,) word constant: int32 bit pattern, or int64 values if wide."""
        key = (value, str(device), wide)
        t = self._consts.get(key)
        if t is None:
            w = int_to_words(value, self.nwords)
            arr = w.astype(np.int64) if wide else w.view(np.int32)
            t = self._consts[key] = torch.as_tensor(arr, device=device)
        return t

    # ------------------------------------------------------------------ util
    def zeros(self, batch_shape=(), device="cpu"):
        return torch.zeros((*batch_shape, self.nwords), dtype=torch.int32,
                           device=device)

    def one(self, batch_shape=(), device="cpu"):
        one = self.const(self.spec.r % self.spec.p, device)
        return one.expand(*batch_shape, self.nwords).clone()

    def is_zero(self, a):
        """Boolean (...,) — true where the element is 0 (any domain)."""
        return (a == 0).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        """where(cond, a, b) with cond shaped (...,) broadcast over words."""
        return torch.where(cond[..., None], a, b)

    def _cond_sub_p(self, x, top):
        """x - p where top * 2^(32W) + x >= p (int32 words in and out)."""
        p = self.const(self.spec.p, x.device, wide=True)
        return words_i32(cond_sub(words_u64(x), top.to(torch.int64), p, 32))

    # -------------------------------------------------------------- add/sub
    def add(self, a, b):
        limbs, top = normalize(words_u64(a) + words_u64(b), 32)
        p = self.const(self.spec.p, limbs.device, wide=True)
        return words_i32(cond_sub(limbs, top, p, 32))

    def sub(self, a, b):
        d, borrow = sub_limbs(words_u64(a), words_u64(b), 32)
        # if borrowed, add p back (cannot re-borrow since p - (b - a) > 0)
        fixed, _ = normalize(d + self.const(self.spec.p, d.device, wide=True), 32)
        return words_i32(torch.where((borrow > 0)[..., None], fixed, d))

    def neg(self, a):
        p = self.const(self.spec.p, a.device, wide=True)
        d, _ = sub_limbs(p, words_u64(a), 32)
        return self.select(self.is_zero(a), a, words_i32(d))

    # ------------------------------------------------------------------ mul
    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (broadcasting), via K1."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        W = self.nwords
        a2 = a.expand(shape).reshape(-1, W).contiguous()
        b2 = b.expand(shape).reshape(-1, W).contiguous()
        return mont_mul(self.spec, a2, b2).reshape(shape)

    def square(self, a):
        return self.mul(a, a)

    # --------------------------------------------------------- domain moves
    def to_mont(self, a):
        return self.mul(a, self.const(self.spec.r2, a.device))

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[..., 0] = 1
        return self.mul(a, one)

    # ------------------------------------------------------------------ pow
    def pow(self, a, e: int):
        """a^e for a fixed python-int exponent (square and multiply)."""
        acc = self.one(a.shape[:-1], a.device)
        for i in reversed(range(max(e.bit_length(), 1))):
            acc = self.square(acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inverse via Fermat: a^(p-2). inv(0) = 0."""
        return self.pow(a, self.spec.p - 2)

    # ------------------------------------------------------------ power sets
    def powers(self, base_mont: torch.Tensor, n: int) -> torch.Tensor:
        """[b^0, b^1, ..., b^(n-1)] as (n, W) Montgomery words on b's device.

        Log-doubling: log2(n) batched products (K1) — the twiddle generator
        of the NTT plans."""
        out = self.one((1,), base_mont.device)
        if n <= 1:
            return out[:n]
        cur = base_mont.reshape(1, self.nwords)          # b^(2^k) walker
        while out.shape[0] < n:
            k = out.shape[0]
            take = min(k, n - k)
            out = torch.cat([out, self.mul(out[:take], cur)])   # b^k .. b^(k+take-1)
            if out.shape[0] < n:
                cur = self.mul(cur, cur)
        return out

    def power_matrix(self, bases_mont: torch.Tensor, m: int) -> torch.Tensor:
        """(n, W) bases -> (n, m, W) matrix M[i, j] = bases[i]^j, Montgomery.

        Log-doubling along j with the whole base column batched: log2(m)
        rounds of K1 products, n*m products in all — the four-step NTT's
        inter-pass twiddle tables (ntt/transform.py)."""
        n = bases_mont.shape[0]
        out = self.one((n, 1), bases_mont.device)
        if m <= 1:
            return out[:, :m]
        cur = bases_mont.reshape(n, 1, self.nwords)        # bases^(2^k) walker
        while out.shape[1] < m:
            k = out.shape[1]
            take = min(k, m - k)
            out = torch.cat([out, self.mul(out[:, :take], cur)], dim=1)
            if out.shape[1] < m:
                cur = self.mul(cur, cur)
        return out

    # ------------------------------------------------------- host transfers
    def from_int(self, values, mont=True, device="cpu"):
        """Python ints -> (len, W) words on `device` (Montgomery by default)."""
        arr = np.stack([int_to_words(v % self.spec.p, self.nwords) for v in values])
        out = torch.as_tensor(arr.view(np.int32), device=device)
        return self.to_mont(out) if mont else out

    def to_int(self, a, mont=True):
        """Device words -> python int or nested list of ints."""
        if mont:
            a = self.from_mont(a)
        arr = a.cpu().numpy().view(np.uint32)
        flat = arr.reshape(-1, self.nwords)
        vals = [words_to_int(row) for row in flat]
        if arr.ndim == 1:
            return vals[0]
        out = np.empty(arr.shape[:-1], dtype=object)
        out.reshape(-1)[:] = vals
        return out.tolist()
