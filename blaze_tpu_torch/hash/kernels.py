"""K10: the fused Poseidon permutation (csrc/poseidon_kernels.cu) and its
plain version.

Replaces blaze_tpu/hash/kernels.py PoseidonKernels (`_perm_fn`, the
pallas_call at :207, behind `permute_lm`): the whole permutation — r_f/2
full rounds, r_p partial rounds, r_f/2 full rounds — in one launch over a
batch of states.  Layout is lanes-major: B states of t elements are (t, W, B)
int32 words (word w of element e of state b at [e, w, b]), the JAX package's
(t, L, B) with 32-bit words in place of 16-bit limbs.  Every value is
canonical (< p).

`permute_lm` launches the kernel for CUDA tensors and runs
`permute_lm_plain` — the same function on 16-bit int64 limbs with the
canonical twin of field.cuh, MDS rows as summed unreduced products reduced
by `PlainFieldOps.redc_sum` — only for CPU tensors.  The kernel runs the
partial rounds sparse (`PoseidonParams.sparse`) where the instance allows
it; the plain version keeps the dense rounds of the TPU kernel, so holding
one against the other also holds the factorization.  Its MDS column sums
come from one exact float64 band product per round.  Bound and design: see
csrc/poseidon_kernels.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..fields.kernel_ops import (
    PlainFieldOps,
    _shift_up,
    conv_cols,
    consts_host,
    limbs16_to_words,
    reduce_multiples,
    words_to_limbs16,
)
from ..fields.spec import FieldSpec, int_to_words
from .params import PoseidonParams, mont_words

__all__ = ["PoseidonKernels", "sum_products", "sum_products_plain"]

_c = ctypes
_ARGTYPES = [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
             _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int64, _c.c_int, _c.c_void_p]
_SUM_ARGTYPES = [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,
                 _c.c_int64, _c.c_void_p, _c.c_int, _c.c_void_p]


def _entry(name: str = "blz_poseidon_perm"):
    fn = getattr(_build.load("poseidon_kernels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES if name == "blz_poseidon_perm" else _SUM_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def sum_products_plain(spec: FieldSpec, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of `sum_products`: PlainFieldOps.redc_sum of the
    summed lazy product columns."""
    ops = PlainFieldOps(spec, lazy=False)
    al, cl = (words_to_limbs16(x.transpose(1, 2)) for x in (a, c))      # (t, B, L)
    cols = conv_cols(al, cl, 2 * ops.L + 1).sum(dim=0)
    return limbs16_to_words(ops.redc_sum(cols, a.shape[0])).t().contiguous()


def sum_products(spec: FieldSpec, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One MDS row's arithmetic on its own, for checks of the multi-p REDC:
    (sum_j a_j c_j) / R mod p, canonical, for canonical (t, W, B) int32
    words a and c -> (W, B).  CUDA tensors run carry.cuh's mul_acc_cc +
    redc_sum (blz_sum_products), CPU tensors the plain version."""
    W = spec.nwords
    if (a.shape != c.shape or a.dim() != 3 or a.shape[1] != W or a.dtype != torch.int32
            or c.dtype != torch.int32 or a.device != c.device):
        raise ValueError("want two (t, W, B) int32 tensors on one device")
    a, c = a.contiguous(), c.contiguous()
    if a.device.type == "cpu":
        return sum_products_plain(spec, a, c)
    t, _, B = a.shape
    mults = reduce_multiples(spec, t)
    mw = torch.from_numpy(np.concatenate([int_to_words(m, W + 1) for m in mults])
                          .view(np.int32)).to(a.device)
    o = torch.empty((W, B), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry("blz_sum_products")(W, consts_host(spec).ctypes.data, a.data_ptr(),
                                        c.data_ptr(), o.data_ptr(), t, B, mw.data_ptr(),
                                        len(mults), stream)
    _build.check(rc, "blz_sum_products")
    return o


class PoseidonKernels:
    """Per-PoseidonParams fused permutation."""

    _CACHE: dict = {}

    @classmethod
    def for_params(cls, params: PoseidonParams) -> "PoseidonKernels":
        # The key must pin the FULL constant set: two CSV-loaded parameter
        # sets with identical (field, t, rounds) but different constants
        # must not share an instance (its constant block is built once),
        # and alpha, which the Grain constants do not depend on, is refused
        # unless 5.
        # Exact tuples, not their hash() — a collision would silently
        # reuse the wrong constants.
        consts = (tuple(params.round_constants),
                  tuple(tuple(row) for row in params.mds))
        key = (params.spec.name, params.t, params.alpha, params.r_f, params.r_p, consts)
        inst = cls._CACHE.get(key)
        if inst is None:
            inst = cls._CACHE[key] = cls(params)
        return inst

    def __init__(self, params: PoseidonParams):
        if params.alpha != 5:
            # blaze_tpu computes x^5 whatever alpha says (its portable S-box,
            # hash/poseidon.py:27-31): no instance with another alpha has
            # words to match, so it is refused
            raise ValueError("the fused S-box is specialized to x^5")
        spec = params.spec
        self.params = params
        self.spec = spec
        self.W = spec.nwords
        self.ops = PlainFieldOps(spec, lazy=False)
        self._consts = consts_host(spec)
        mults = reduce_multiples(spec, params.t)
        self._nm = len(mults)
        # the kernel's constant block (csrc/poseidon.cuh), Montgomery forms:
        # sparse: the full rounds' and partial rounds' constants, mds, pre,
        # the sparse rows and columns; dense (an M whose lower-right block is
        # singular): rc and mds; then R^2 mod p and the multiples 2^b p of
        # the mixes' REDC (W+1 words each)
        sf = params.sparse
        self.sparse = sf is not None
        if self.sparse:
            tables = [mont_words(spec, v) for v in (sf.rc_full, sf.rc_partial, params.mds,
                                                    sf.pre, sf.rows, sf.cols)]
        else:
            tables = [params.rc_mont, params.mds_mont]
        self._block = np.concatenate(
            [a.reshape(-1).view(np.uint32) for a in tables]
            + [int_to_words(spec.r2, self.W)]
            + [int_to_words(m, self.W + 1) for m in mults]
        ).view(np.int32)
        self._dev_cache: dict = {}

    def _block_on(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        blk = self._dev_cache.get(key)
        if blk is None:
            blk = self._dev_cache[key] = torch.from_numpy(self._block).to(device)
        return blk

    # ------------------------------------------------------------- plain
    def _sbox_plain(self, x: torch.Tensor) -> torch.Tensor:
        x2 = self.ops.mul(x, x)
        x4 = self.ops.mul(x2, x2)
        return self.ops.mul(x4, x)

    def _mds_band(self, device) -> torch.Tensor:
        """(t(2L-1), tL) float64 band of the Montgomery MDS: entry ((i, k),
        (j, v)) is limb k - v of M_ij, so band @ limbs gives every row's
        column sums of sum_j M_ij s_j at once.  The product is exact: each
        partial sum is below t L 2^32 < 2^53."""
        key = ("band", str(device))
        band = self._dev_cache.get(key)
        if band is None:
            t, L = self.params.t, self.ops.L
            m = words_to_limbs16(torch.from_numpy(self.params.mds_mont)).permute(0, 2, 1)
            band = torch.zeros(t, 2 * L - 1, t, L, dtype=torch.float64)
            for v in range(L):
                band[:, v:v + L, :, v] = m.double()                  # [i, u, j] at k = u + v
            band = self._dev_cache[key] = band.reshape(t * (2 * L - 1), t * L).to(device)
        return band

    def _mds_cols(self, s: torch.Tensor) -> torch.Tensor:
        """(t, B, L) limbs -> (t, B, 2L+1) lazy column sums of the MDS rows,
        each column below 2^17 (two carry folds of the < 2^40 sums)."""
        t, B, L = s.shape
        c = self._mds_band(s.device) @ s.permute(0, 2, 1).reshape(t * L, B).double()
        c = torch.nn.functional.pad(
            c.long().reshape(t, 2 * L - 1, B).permute(0, 2, 1), (0, 2))
        for _ in range(2):
            c = (c & 0xFFFF) + _shift_up(c >> 16, 1)
        return c

    def permute_lm_plain(self, state: torch.Tensor, convert_in: bool = False) -> torch.Tensor:
        """Plain PyTorch version of `permute_lm` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        p, ops = self.params, self.ops
        t, dev = p.t, state.device
        s = words_to_limbs16(state.transpose(1, 2))                  # (t, B, L)
        rc = words_to_limbs16(torch.from_numpy(p.rc_mont).to(dev))   # (rounds, t, L)
        if convert_in:
            s = ops.mul(s, ops.const(self.spec.r2, dev))
        half = p.r_f // 2
        for r in range(p.r_f + p.r_p):
            s = ops.add(s, rc[r][:, None, :])
            if r < half or r >= half + p.r_p:
                s = self._sbox_plain(s)
            else:
                s = torch.cat([self._sbox_plain(s[:1]), s[1:]])
            # row i: sum_j M_ij s_j as lazy columns, then one multi-p REDC
            s = ops.redc_sum(self._mds_cols(s), t)
        return limbs16_to_words(s).transpose(1, 2).contiguous()

    # ------------------------------------------------------------ kernel
    def permute_lm(self, state: torch.Tensor, convert_in: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fused permutation of (t, W, B) int32 states.

        Montgomery form in and out; with convert_in=True the input is
        CANONICAL and converted inside the kernel (one extra product per
        element, x * R^2 / R = xR).  `out` may be `state` itself (in place).
        """
        t, W = self.params.t, self.W
        if state.dtype != torch.int32 or state.dim() != 3 or state.shape[:2] != (t, W):
            raise ValueError(
                f"state: want ({t}, {W}, B) int32, got {tuple(state.shape)} {state.dtype}"
            )
        if not state.is_contiguous():
            raise ValueError("state: not contiguous")
        if out is not None and (out.shape != state.shape or out.dtype != state.dtype
                                or out.device != state.device or not out.is_contiguous()):
            raise ValueError("out differs from the state in shape, type, device or layout")
        if state.device.type == "cpu":
            res = self.permute_lm_plain(state, convert_in)
            return res if out is None else out.copy_(res)
        if state.device.type != "cuda":
            raise ValueError(f"unsupported device {state.device}")
        o = torch.empty_like(state) if out is None else out
        B = state.shape[2]
        if B:
            p = self.params
            with torch.cuda.device(state.device):
                stream = torch.cuda.current_stream(state.device).cuda_stream
                rc = _entry()(W, self._consts.ctypes.data,
                              self._block_on(state.device).data_ptr(), t, p.r_f, p.r_p,
                              self._nm, int(self.sparse), state.data_ptr(), o.data_ptr(), B,
                              int(convert_in), stream)
            _build.check(rc, "blz_poseidon_perm")
            _build.LAUNCHES["poseidon_perm"] += 1
        return o

    def permute_pm(self, state: torch.Tensor) -> torch.Tensor:
        """Points-major adapter: (..., t, W) Montgomery -> same, via the
        fused permutation."""
        t, W = self.params.t, self.W
        batch = state.shape[:-2]
        lm = state.reshape(-1, t, W).permute(1, 2, 0).contiguous()   # (t, W, B)
        return self.permute_lm(lm).permute(2, 0, 1).reshape(*batch, t, W)
