"""Montgomery field arithmetic on torch tensors of 32-bit words.

All ops act on `int32[..., W]` tensors (little-endian uint32 words, value
< p, Montgomery form) and are elementwise over every leading batch
dimension.  `mul` is the K1 kernel (fields/montmul.py); add / sub / neg /
double and the conditional subtraction of p are the KF kernel
(fields/elementwise.py), where the JAX package's were XLA ops; on CPU
tensors both run their plain versions.  Every op keeps the canonical < p
invariant, so results equal blaze_tpu's Field bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .elementwise import field_ew
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

    def const(self, value: int, device) -> torch.Tensor:
        """(W,) int32 word constant, cached per device."""
        key = (value, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                int_to_words(value, self.nwords).view(np.int32), device=device)
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

    def eq(self, a, b):
        """Boolean (...,) — true where a and b are the same words."""
        return (a == b).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        """where(cond, a, b) with cond shaped (...,) broadcast over words."""
        return torch.where(cond[..., None], a, b)

    def _cond_sub_p(self, x, top=None):
        """x - p where top * 2^(32W) + x >= p (int32 words in and out; no
        top: x < 2p, brought below p)."""
        return field_ew(self.spec, "canon", x, top)

    # -------------------------------------------------------------- add/sub
    def add(self, a, b):
        return field_ew(self.spec, "add", a, b)

    def sub(self, a, b):
        return field_ew(self.spec, "sub", a, b)

    def double(self, a):
        return field_ew(self.spec, "double", a)

    def neg(self, a):
        return field_ew(self.spec, "neg", a)

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
