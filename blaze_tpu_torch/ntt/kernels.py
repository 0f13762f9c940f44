"""K7-K9: the NTT's kernels (csrc/ntt_kernels.cu) and their plain versions.

Replaces blaze_tpu/ntt/kernels.py NTTKernels.  Layout is lanes-major: a
batch of B values per row is (R, W, B) int32 words (word w of row r, lane b
at [r, w, b]) — the JAX package's (R, L, B) with 32-bit words in place of
16-bit limbs.  Every value is canonical (< p): the scalar fields have
R < 4p, so these kernels use field.cuh's canonical discipline only.

Each public method launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it only for CPU tensors.  The plain versions compute
the same function on 16-bit int64 limbs with the canonical twin of
field.cuh (fields/kernel_ops.py), so the CPU tests hold them limb for limb
against the JAX kernels in interpret mode.  Bounds and design: see
csrc/ntt_kernels.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..fields.kernel_ops import (
    PlainFieldOps,
    consts_host,
    limbs16_to_words,
    words_to_limbs16,
)
from ..fields.spec import FieldSpec
from .transform import _bitrev_perm

__all__ = ["NTTKernels", "lane_cols"]

MAX_LOGK = 9      # K7's shared-memory tile holds up to 2^9 points per lane

_c = ctypes
_ARGTYPES = {
    "blz_ntt_base": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                     _c.c_int, _c.c_int64, _c.c_void_p],
    "blz_mul_lm": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_void_p],
    "blz_twiddle_mul": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                        _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                        _c.c_void_p],
}


def lane_cols(J: int, S: int, B: int, device):
    """Per-lane (jo, jl) of lane (jo*S + jl)*B + b: the split-table columns
    of each lane of a twiddle cell."""
    j = torch.arange(J * S * B, device=device) // B
    return j // S, j % S


def _entry(name: str):
    fn = getattr(_build.load("ntt_kernels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


class NTTKernels:
    """Per-field NTT kernels. Cached per FieldSpec."""

    _CACHE: dict = {}

    @classmethod
    def for_spec(cls, spec: FieldSpec) -> "NTTKernels":
        inst = cls._CACHE.get(spec.name)
        if inst is None:
            inst = cls._CACHE[spec.name] = cls(spec)
        return inst

    def __init__(self, spec: FieldSpec):
        if spec.nwords != 8:
            raise ValueError(f"{spec.name}: the NTT kernels take 8-word fields only")
        self.spec = spec
        self.W = spec.nwords
        self.ops = PlainFieldOps(spec, lazy=False)
        self._consts = consts_host(spec)

    # ------------------------------------------------------------ plumbing
    def _check(self, x: torch.Tensor, what: str) -> None:
        if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != self.W:
            raise ValueError(
                f"{what}: want (R, {self.W}, N) int32, got {tuple(x.shape)} {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: unsupported device {x.device}")

    def _out(self, x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
        if out is None:
            return torch.empty_like(x)
        if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
            raise ValueError("out differs from the input in shape, type or device")
        if not out.is_contiguous():
            raise ValueError("out: not contiguous")
        return out

    def _launch(self, name: str, counter: str, dev: torch.device, *args) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _entry(name)(self.W, self._consts.ctypes.data, *args, stream)
        _build.check(rc, name)
        _build.LAUNCHES[counter] += 1

    @staticmethod
    def _limbs(x: torch.Tensor) -> torch.Tensor:
        """(R, W, N) int32 words -> (R, N, L) int64 limbs (plain versions)."""
        return words_to_limbs16(x.transpose(1, 2))

    @staticmethod
    def _words(x: torch.Tensor) -> torch.Tensor:
        """(R, N, L) int64 limbs -> (R, W, N) int32 words."""
        return limbs16_to_words(x).transpose(1, 2).contiguous()

    # ----------------------------------------------------------------- K7
    def ntt_base_plain(self, x: torch.Tensor, pack: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch version of `ntt_base` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        K, _, B = x.shape
        logK = K.bit_length() - 1
        rev = torch.as_tensor(_bitrev_perm(logK), device=x.device)
        v = self._limbs(x[rev])                           # (K, B, L), bit-reversed
        tw = words_to_limbs16(pack)                       # (K, L)
        L = v.shape[-1]
        for s in range(logK):
            m, g2 = 1 << s, K >> (s + 1)
            vr = v.reshape(g2, 2, m, B, L)
            a, b = vr[:, 0], vr[:, 1]
            if s:                                        # stage 0's twiddle is 1
                w = tw[m - 1 : 2 * m - 1][None, :, None, :].expand(g2, m, B, L)
                b = self.ops.mul(w, b)
            v = torch.stack([self.ops.add(a, b), self.ops.sub(a, b)], dim=1)
            v = v.reshape(K, B, L)
        return self._words(v)

    def ntt_base(self, x: torch.Tensor, pack: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One whole K-point radix-2 DIT NTT per lane.

        x: (K, W, B) int32 canonical words in NATURAL order (the bit-reversal
        is folded into the kernel's loads; the JAX kernel took bit-reversed
        input).  pack: (K, W) stage-packed twiddles — entry m-1+t (m = 2^s)
        is W_K^(t << (logK-1-s)).  Returns (K, W, B) natural order,
        canonical; `out` may be x itself (in place).
        """
        self._check(x, "x")
        K = x.shape[0]
        logK = K.bit_length() - 1
        if K != 1 << logK or not 1 <= logK <= MAX_LOGK:
            raise ValueError(f"ntt_base: K = {K} is not a power of two in [2, 512]")
        if pack.shape != (K, self.W) or pack.dtype != torch.int32 \
                or pack.device != x.device or not pack.is_contiguous():
            raise ValueError(f"pack: want contiguous ({K}, {self.W}) int32 on {x.device}")
        if x.device.type == "cpu":
            res = self.ntt_base_plain(x, pack)
            return res if out is None else self._out(x, out).copy_(res)
        o = self._out(x, out)
        if x.shape[2]:
            self._launch("blz_ntt_base", "ntt_base", x.device, x.data_ptr(),
                         pack.data_ptr(), o.data_ptr(), logK, x.shape[2])
        return o

    # ----------------------------------------------------------------- K8
    def mul_lm_plain(self, x: torch.Tensor, y: torch.Tensor,
                     z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain PyTorch version of `mul_lm`."""
        acc = self.ops.mul(self._limbs(x), self._limbs(y))
        if z is not None:
            acc = self.ops.mul(acc, self._limbs(z))
        return self._words(acc)

    def mul_lm(self, x: torch.Tensor, y: torch.Tensor,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Elementwise Montgomery product x*y (or x*y*z) of (M, W, N) batches,
        canonical."""
        ops = [x, y] + ([z] if z is not None else [])
        for i, t in enumerate(ops):
            self._check(t, "xyz"[i])
            if t.shape != x.shape or t.device != x.device:
                raise ValueError("operands differ in shape or device")
        if x.device.type == "cpu":
            return self.mul_lm_plain(x, y, z)
        o = torch.empty_like(x)
        M, _, N = x.shape
        if M and N:
            self._launch("blz_mul_lm", "mul_lm", x.device, x.data_ptr(), y.data_ptr(),
                         None if z is None else z.data_ptr(), o.data_ptr(), M, N)
        return o

    # ----------------------------------------------------------------- K9
    def twiddle_mul_plain(self, y: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                          B: int) -> torch.Tensor:
        """Plain PyTorch version of `twiddle_mul`: the table columns are
        gathered per lane, then two products."""
        jo, jl = lane_cols(t1.shape[2], t2.shape[2], B, y.device)
        acc = self.ops.mul(self._limbs(t1.index_select(2, jo)), self._limbs(y))
        return self._words(self.ops.mul(acc, self._limbs(t2.index_select(2, jl))))

    def twiddle_mul(self, y: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, B: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inter-level twiddle: entry (v, lane) times T1[v, jo] * T2[v, jl].

        y: (A, W, J*S*B), lane = (jo*S + jl)*B + b; t1: (A, W, J), t2:
        (A, W, S) split tables (fused.py).  Returns (A, W, J*S*B) canonical;
        `out` may be y itself (in place)."""
        self._check(y, "y")
        self._check(t1, "t1")
        self._check(t2, "t2")
        A, _, lanes = y.shape
        J, S = t1.shape[2], t2.shape[2]
        if t1.shape[0] != A or t2.shape[0] != A or lanes != J * S * B:
            raise ValueError(f"twiddle_mul: y {tuple(y.shape)}, J {J}, S {S}, B {B}")
        if t1.device != y.device or t2.device != y.device:
            raise ValueError("operands differ in device")
        if y.device.type == "cpu":
            res = self.twiddle_mul_plain(y, t1, t2, B)
            return res if out is None else self._out(y, out).copy_(res)
        o = self._out(y, out)
        if A and lanes:
            self._launch("blz_twiddle_mul", "twiddle_mul", y.device, y.data_ptr(),
                         t1.data_ptr(), t2.data_ptr(), o.data_ptr(), A, J, S, B)
        return o
