"""Plain PyTorch twin of the CUDA field library (csrc/field.cuh, K0).

`PlainFieldOps` computes exactly what field.cuh's device functions compute
— the Montgomery product, add and sub in either reduction discipline, and
the multi-p reduction of a sum of products (`redc_sum`) — on
int64 tensors of 16-bit limbs (torch on the CPU has no uint32 shifts or
adds, and a 16x16-bit product is exact in int64).  It is what the plain
versions of the kernels (fields/montmul.py, curves/kernels.py,
ntt/kernels.py, hash/kernels.py) run, so the CPU tests hold the kernels'
arithmetic against the JAX package.

The carry helpers here (`normalize`, `sub_limbs`, `cond_sub`) take the limb
width as an argument: 16 for these limbs, 32 for the Field's word-level
add/sub (fields/mont.py).  Both follow fields/mont.py of the JAX package:
one value fold puts every limb within a unit carry of final, and a
Kogge-Stone prefix resolves the ripple in log2(K) vectorized rounds.

Also here: `words_to_limbs16` / `limbs16_to_words` between the port's int32
word tensors and these limbs, and `consts_host`, the constant block every
kernel takes (`field_consts`: cached per field).
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
    return torch.nn.functional.pad(v[..., :-d], (d, 0))


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


_SELECTORS: dict = {}


def _diag_selector(La: int, Lb: int, width: int, device) -> torch.Tensor:
    """(Lb*La, width) float64 0/1 matrix sending product (j, i) to column
    i + j (dropped at or past `width`)."""
    key = (La, Lb, width, str(device))
    sel = _SELECTORS.get(key)
    if sel is None:
        j, i = torch.meshgrid(torch.arange(Lb), torch.arange(La), indexing="ij")
        col = (i + j).reshape(-1)
        sel = torch.zeros(Lb * La, width, dtype=torch.float64)
        keep = col < width
        sel[torch.arange(Lb * La)[keep], col[keep]] = 1.0
        sel = _SELECTORS[key] = sel.to(device)
    return sel


def conv_cols(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Lazy-carry column sums of the integer product of limb vectors a, b
    (16-bit int64 limbs), the first `width` columns, each below 2^17.

    Each column is one exact float64 sum of at most min(La, Lb) products
    below 2^32 (below 2^53 for any limb count used here), gathered by a
    0/1 selector matrix; two carry folds bring the columns below 2^17
    without changing the value mod 2^(16 width) (blaze_tpu
    fields/mont.py:_conv_cols computes the same value)."""
    La, Lb = a.shape[-1], b.shape[-1]
    prod = a[..., None, :] * b[..., :, None]            # (*batch, Lb, La)
    batch = prod.shape[:-2]
    cols = (prod.reshape(*batch, Lb * La).double()
            @ _diag_selector(La, Lb, width, prod.device)).long()
    for _ in range(2):
        cols = (cols & _M16) + _shift_up(cols >> 16, 1)
    return cols


# --------------------------------------------------------------- constants
def reduce_multiples(spec: FieldSpec, terms: int) -> list:
    """The multiples 2^b p, b from high to low, whose conditional
    subtraction brings a reduced sum of `terms` products (below
    (subs + 1) p, subs = terms*p // R + 1) below p."""
    subs = terms * spec.p // spec.r + 1
    return [spec.p << b for b in reversed(range(subs.bit_length()))]


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


_FIELD_CONSTS: dict = {}


def field_consts(spec: FieldSpec) -> np.ndarray:
    """consts_host(spec), cached per field: the block K1 and KF take."""
    c = _FIELD_CONSTS.get(spec.name)
    if c is None:
        c = _FIELD_CONSTS[spec.name] = consts_host(spec)
    return c


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

    def redc_sum(self, t: torch.Tensor, terms: int) -> torch.Tensor:
        """Multi-p Montgomery reduction (field.cuh redc_sum): t holds the
        (..., 2L+1) lazy column sums of up to `terms` products of canonical
        values, T < terms * p^2.  Returns the canonical (T + m p)/R mod p,
        m = T(-p^-1) mod R.  The reduced value is below (subs + 1) p with
        subs = terms*p // R + 1 (blaze_tpu hash/kernels.py:92); conditional
        subtractions of 2^b p, b from high to low (`reduce_multiples`),
        bring it below p.  Canonical only."""
        if self.lazy:
            raise ValueError("redc_sum gives canonical values only")
        spec, L = self.spec, self.L
        dev = t.device
        p = self.const(spec.p, dev)
        t_lo, c_lo = normalize(t[..., :L], 16)
        m, _ = normalize(conv_cols(t_lo, self.const(spec.nprime, dev), L), 16)
        q = conv_cols(m, p, 2 * L + 1)
        _, c1 = normalize(t_lo + q[..., :L], 16)
        limbs, top = normalize(t[..., L : 2 * L] + q[..., L : 2 * L], 16,
                               carry_in=c1 + c_lo)
        x = torch.cat([limbs, (top + t[..., 2 * L] + q[..., 2 * L])[..., None]], dim=-1)
        for mult in reduce_multiples(spec, terms):
            sub, borrow = sub_limbs(x, self._wide(mult, dev), 16)
            x = torch.where((borrow == 0)[..., None], sub, x)
        return x[..., :L]

    def _wide(self, value: int, device) -> torch.Tensor:
        """(L+1,) int64 limbs of a constant below 2^(16(L+1))."""
        key = ("wide", value, str(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(
                int_to_limbs(value, self.L + 1).astype(np.int64), device=device
            )
        return t

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
