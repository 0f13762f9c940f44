"""Plain PyTorch twin of the CUDA field library (csrc/field.cuh, K0).

`PlainFieldOps` computes exactly what field.cuh's device functions compute
— the Montgomery product, add and sub in either reduction discipline — on
int64 tensors of 16-bit limbs (torch on the CPU has no uint32 shifts or
adds, and a 16x16-bit product is exact in int64).  It is what the plain
versions of the kernels (fields/montmul.py, curves/kernels.py) run, so the
CPU tests hold the kernels' arithmetic against the JAX package.

The carry helpers here (`normalize`, `sub_limbs`, `cond_sub`) take the limb
width as an argument: 16 for these limbs, 32 for the Field's word-level
add/sub (fields/mont.py).  Both follow fields/mont.py of the JAX package:
one value fold puts every limb within a unit carry of final, and a
Kogge-Stone prefix resolves the ripple in log2(K) vectorized rounds.

Also here: `words_to_limbs16` / `limbs16_to_words` between the port's int32
word tensors and these limbs, and `consts_host`, the constant block every
kernel takes.
"""
from __future__ import annotations

import numpy as np
import torch

from .spec import LIMB_BITS, FieldSpec, int_to_limbs, int_to_words

_M16 = (1 << LIMB_BITS) - 1
_M32 = (1 << 32) - 1


# ------------------------------------------------------------ conversions
def words_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 words (uint32 bit patterns) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def words_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def words_to_limbs16(w: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 2W) int64 16-bit limbs."""
    u = words_u64(w)
    return torch.stack([u & _M16, u >> 16], dim=-1).reshape(
        *w.shape[:-1], 2 * w.shape[-1]
    )


def limbs16_to_words(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int64 16-bit limbs -> (..., L/2) int32 words."""
    return words_i32(x[..., 0::2] | (x[..., 1::2] << 16))


# --------------------------------------------------------- carry helpers
def _shift_up(v: torch.Tensor, d: int) -> torch.Tensor:
    """v moved up by d positions along the last axis (zero fill)."""
    z = torch.zeros((*v.shape[:-1], d), dtype=v.dtype, device=v.device)
    return torch.cat([z, v[..., :-d]], dim=-1)


def _kogge_stone(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive carry-lookahead scan of 0/1 generate/propagate flags."""
    d, K = 1, g.shape[-1]
    while d < K:
        g = g | (p & _shift_up(g, d))
        p = p & _shift_up(p, d)
        d *= 2
    return g


def normalize(cols: torch.Tensor, bits: int, carry_in=None):
    """Carry-propagate int64 columns of `bits`-wide limbs whose values are
    below 2^(2*bits - 1).  Returns (limbs < 2^bits, top carry out)."""
    mask = (1 << bits) - 1
    lo = cols & mask
    hi = cols >> bits
    t = lo + _shift_up(hi, 1)
    if carry_in is not None:
        t = torch.cat([t[..., :1] + carry_in[..., None], t[..., 1:]], dim=-1)
    g = t >> bits
    p = ((t & mask) == mask).to(torch.int64)
    G = _kogge_stone(g, p)
    limbs = (t + _shift_up(G, 1)) & mask
    return limbs, hi[..., -1] + G[..., -1]


def sub_limbs(x: torch.Tensor, y: torch.Tensor, bits: int):
    """(x - y) mod 2^(bits*K) with borrow lookahead -> (limbs, borrow)."""
    mask = (1 << bits) - 1
    u = x + (1 << bits) - y
    g = 1 - (u >> bits)
    p = ((u & mask) == 0).to(torch.int64)
    G = _kogge_stone(g, p)
    return (u - _shift_up(G, 1)) & mask, G[..., -1]


def cond_sub(limbs: torch.Tensor, top: torch.Tensor, m: torch.Tensor, bits: int):
    """limbs - m where top * 2^(bits*K) + limbs >= m, else limbs."""
    sub, borrow = sub_limbs(limbs, m, bits)
    return torch.where(((top > 0) | (borrow == 0))[..., None], sub, limbs)


def conv_cols(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Lazy-carry column sums of the integer product of limb vectors a, b
    (16-bit int64 limbs), each product split into lo/hi 16-bit halves so
    every column stays below 2^23.  Shear-reshape form of
    blaze_tpu fields/mont.py:_conv_cols."""
    La, Lb = a.shape[-1], b.shape[-1]
    prod = a[..., None, :] * b[..., :, None]            # (*batch, Lb, La)
    batch = prod.shape[:-2]
    lo = prod & _M16
    hi = prod >> 16
    rows = torch.nn.functional.pad(lo, (0, 1)) + torch.nn.functional.pad(hi, (1, 0))
    W = max(width, La + Lb + 1)
    rows = torch.nn.functional.pad(rows, (0, W + 1 - (La + 1)))
    flat = rows.reshape(*batch, Lb * (W + 1))[..., : Lb * W]
    return flat.reshape(*batch, Lb, W).sum(dim=-2)[..., :width]


# --------------------------------------------------------------- constants
def consts_host(spec: FieldSpec, b3_mont: int = 0) -> np.ndarray:
    """The constant block every kernel takes (csrc/field.cuh FieldConsts):
    p, 2p, R mod p, 3b*R mod p as W words each, then -p^-1 mod 2^32."""
    W = spec.nwords
    return np.concatenate([
        int_to_words(spec.p, W),
        int_to_words(2 * spec.p, W),
        int_to_words(spec.r % spec.p, W),
        int_to_words(b3_mont, W),
        np.asarray([spec.n0inv32], dtype=np.uint32),
    ]).astype(np.uint32)


class PlainFieldOps:
    """field.cuh's mont_mul / fadd / fsub on (..., L) int64 16-bit limbs.

    lazy=True: values < 2p (needs R > 4p), products skip the final
    subtraction, add/sub reduce against 2p.  lazy=False: canonical < p."""

    def __init__(self, spec: FieldSpec, lazy: bool):
        if lazy and not spec.r > 4 * spec.p:
            raise ValueError(f"{spec.name}: lazy reduction needs R > 4p")
        self.spec = spec
        self.lazy = lazy
        self.L = spec.nlimbs
        self._consts: dict = {}

    def const(self, value: int, device) -> torch.Tensor:
        """(L,) int64 limbs of a constant integer, cached per device."""
        key = (value, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                int_to_limbs(value, self.L).astype(np.int64), device=device
            )
        return t

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R: the value (T + m p)/R, m = T(-p^-1) mod R,
        then one conditional subtraction of p unless lazy."""
        spec, L = self.spec, self.L
        dev = a.device
        p = self.const(spec.p, dev)
        t = conv_cols(a, b, 2 * L + 1)
        t_lo, c_lo = normalize(t[..., :L], 16)
        m, _ = normalize(conv_cols(t_lo, self.const(spec.nprime, dev), L), 16)
        q = conv_cols(m, p, 2 * L + 1)
        _, c1 = normalize(t_lo + q[..., :L], 16)      # low half is 0 mod R
        limbs, top = normalize(t[..., L : 2 * L] + q[..., L : 2 * L], 16,
                               carry_in=c1 + c_lo)
        if self.lazy:
            return limbs
        return cond_sub(limbs, top + t[..., 2 * L] + q[..., 2 * L], p, 16)

    def _modulus(self, device) -> torch.Tensor:
        return self.const((2 if self.lazy else 1) * self.spec.p, device)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b, less the modulus (2p lazy, p canonical) when that fits;
        the lazy form ignores the carry out, as field.cuh does."""
        limbs, top = normalize(a + b, 16)
        if self.lazy:
            top = torch.zeros_like(top)
        return cond_sub(limbs, top, self._modulus(a.device), 16)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b, plus the modulus (2p lazy, p canonical) mod R on borrow."""
        d, borrow = sub_limbs(a, b, 16)
        fixed, _ = normalize(d + self._modulus(d.device), 16)
        return torch.where((borrow > 0)[..., None], fixed, d)
