"""K7-K9: the NTT's kernels (csrc/ntt_kernels.cu) and their plain versions.

Replaces blaze_tpu/ntt/kernels.py NTTKernels.  K7 and K9 take
element-contiguous buffers, (N, W) int32 words (an element's W words
together), W = 8 (the scalar fields) or 12 (bls12_377_fq, 2-adicity 46);
K8 takes (M, W, N) lanes-major words, the JAX package's (R, L, B)
with 32-bit words in place of 16-bit limbs, and FusedNTT hands it element
rows, (n, W, 1).  Every value is canonical
(< p): the scalar fields have R < 4p, so these kernels use the canonical
discipline only.

K7 reads and writes through a `TileMap`: point k of lane l of a batch of
K-point transforms lies at row k * ks + sum over its bit fields (src, wid,
dst) of ((l >> src) % 2^wid) << dst, so FusedNTT hands each Cooley-Tukey
level its strides instead of a transposed copy.  K9 finds each element's
twiddle row and column in bit fields of its row, in the same form
(`bit_fields_host`, csrc/ntt.cuh BitFields).

Each public method launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it only for CPU tensors.  The plain versions compute
the same function on 16-bit int64 limbs with the canonical twin of
field.cuh (fields/kernel_ops.py), so the CPU tests hold them limb for limb
against the JAX kernels in interpret mode.  Bounds and design: see
csrc/ntt_kernels.cu and csrc/ntt.cuh.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..fields.kernel_ops import (
    PlainFieldOps,
    consts_host,
    limbs16_to_words,
    words_to_limbs16,
)
from ..fields.spec import FieldSpec

__all__ = ["NTTKernels", "TileMap", "twiddle_cols"]

NTT_WORDS = (8, 12)   # the element widths csrc/ntt_kernels.cu is built for
MAX_LOGK = 9      # K7's shared-memory tile holds up to 2^9 points per lane
MAX_FIELDS = 6    # bit fields of a TileMap or of K9's row map
LANE_BITS = 31    # a field this wide holds any lane index whole

_c = ctypes
_ARGTYPES = {
    "blz_ntt_base": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                     _c.c_int, _c.c_int64, _c.c_void_p, _c.c_void_p, _c.c_void_p],
    "blz_mul_lm": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_void_p, _c.c_int64, _c.c_int64, _c.c_void_p],
    "blz_twiddle_mul": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                        _c.c_void_p, _c.c_int64, _c.c_int, _c.c_int, _c.c_int,
                        _c.c_void_p, _c.c_void_p],
}


def _bitrev_perm(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def field_sum(x: torch.Tensor, fields) -> torch.Tensor:
    """Sum over `fields` (src, wid, dst) of ((x >> src) % 2^wid) << dst."""
    out = torch.zeros_like(x)
    for src, wid, dst in fields:
        out += ((x >> src) & ((1 << wid) - 1)) << dst
    return out


def field_max(fields, top: int) -> int:
    """The largest field_sum of an index below `top`."""
    return sum(min((1 << wid) - 1, (top - 1) >> src) << dst for src, wid, dst in fields)


def check_fields(fields, what: str) -> tuple:
    fields = tuple(tuple(int(v) for v in f) for f in fields)
    if len(fields) > MAX_FIELDS or any(
            len(f) != 3 or min(f) < 0 or f[0] > 62 or f[1] > 32 or f[1] + f[2] > 62
            for f in fields):
        raise ValueError(f"{what}: bit fields {fields} out of range")
    return fields


def bit_fields_host(head: int, fields) -> np.ndarray:
    """The C entries' form of a head and its bit fields (csrc/ntt.cuh
    BitFields): head, then (src, wid, dst) per field, unused fields (0, 0,
    0), int64."""
    pad = [(0, 0, 0)] * (MAX_FIELDS - len(fields))
    return np.array([head, *(v for f in (*fields, *pad) for v in f)], dtype=np.int64)


class TileMap(NamedTuple):
    """Where point k of lane l of a batch of K-point transforms lies in an
    element-contiguous (N, W) buffer: row k * ks + field_sum(l, fields),
    each field (src, wid, dst) one lane digit of a power-of-two size at a
    power-of-two stride (csrc/ntt.cuh TileMap)."""

    ks: int
    fields: tuple = ()

    @staticmethod
    def lanes_at(ks: int, log_stride: int = 0) -> "TileMap":
        """Point k of lane l at row k * ks + (l << log_stride)."""
        return TileMap(ks, ((0, LANE_BITS, log_stride),))

    @staticmethod
    def rows(lanes: int) -> "TileMap":
        """(K, lanes) rows: point k of lane l at row k * lanes + l."""
        return TileMap.lanes_at(lanes)

    def offsets(self, K: int, lanes: int, device) -> torch.Tensor:
        """(K, lanes) int64 rows of every point."""
        off = field_sum(torch.arange(lanes, dtype=torch.int64, device=device), self.fields)
        return torch.arange(K, dtype=torch.int64, device=device)[:, None] * self.ks + off

    def bound(self, K: int, lanes: int) -> int:
        """The last row it reaches, plus one."""
        return (K - 1) * self.ks + field_max(self.fields, lanes) + 1

    def host(self) -> np.ndarray:
        return bit_fields_host(self.ks, check_fields(self.fields, "TileMap"))


def twiddle_cols(N: int, logA: int, vshift: int, fields, logS: int, device):
    """Row v and columns (jo, jl) of the split tables for each of N element
    rows: v = (pos >> vshift) % 2^logA, j = field_sum(pos, fields) =
    jo * 2^logS + jl."""
    pos = torch.arange(N, dtype=torch.int64, device=device)
    j = field_sum(pos, fields)
    return (pos >> vshift) & ((1 << logA) - 1), j >> logS, j & ((1 << logS) - 1)


def _entry(name: str):
    fn = getattr(_build.load("ntt_kernels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _log2(v: int, what: str) -> int:
    if v < 1 or v & (v - 1):
        raise ValueError(f"{what} = {v} is not a power of two")
    return v.bit_length() - 1


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
        if spec.nwords not in NTT_WORDS:
            raise ValueError(f"{spec.name}: the NTT kernels are built for {NTT_WORDS} "
                             f"words, not {spec.nwords}")
        self.spec = spec
        self.W = spec.nwords
        self.ops = PlainFieldOps(spec, lazy=False)
        self._consts = consts_host(spec)

    # ------------------------------------------------------------ plumbing
    def counter(self, name: str) -> str:
        """The launch counter (_build.LAUNCHES) of kernel `name`'s build for
        this field's width: the name itself at W = 8, name_w12 at W = 12."""
        return name if self.W == 8 else f"{name}_w{self.W}"

    def _check(self, x: torch.Tensor, what: str) -> None:
        if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != self.W:
            raise ValueError(
                f"{what}: want (R, {self.W}, N) int32, got {tuple(x.shape)} {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: unsupported device {x.device}")

    def _launch(self, name: str, counter: str, dev: torch.device, *args) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _entry(name)(self.W, self._consts.ctypes.data, *args, stream)
        _build.check(rc, name)
        _build.LAUNCHES[self.counter(counter)] += 1

    @staticmethod
    def _limbs(x: torch.Tensor) -> torch.Tensor:
        """(R, W, N) int32 words -> (R, N, L) int64 limbs (plain versions)."""
        return words_to_limbs16(x.transpose(1, 2))

    @staticmethod
    def _words(x: torch.Tensor) -> torch.Tensor:
        """(R, N, L) int64 limbs -> (R, W, N) int32 words."""
        return limbs16_to_words(x).transpose(1, 2).contiguous()

    # ----------------------------------------------------------------- K7
    def _elements(self, x: torch.Tensor, what: str) -> None:
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != self.W:
            raise ValueError(f"{what}: want (N, {self.W}) int32, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: unsupported device {x.device}")
        if x.device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{what}: not 16-byte aligned")

    def _ntt_args(self, x, pack, lanes, xmap, out, omap):
        """Checked (K, lanes, xmap, out, omap) of an ntt_base call."""
        self._elements(x, "x")
        K = pack.shape[0] if pack.dim() == 2 else 0
        if K < 2 or K & (K - 1) or K > 1 << MAX_LOGK:
            raise ValueError(f"ntt_base: K = {K} is not a power of two in [2, 512]")
        if pack.shape != (K, self.W) or pack.dtype != torch.int32 \
                or pack.device != x.device or not pack.is_contiguous() \
                or (x.device.type == "cuda" and pack.data_ptr() % 16):
            raise ValueError(f"pack: want contiguous, aligned ({K}, {self.W}) int32 "
                             f"on {x.device}")
        if lanes is None:
            lanes = x.shape[0] // K
        xmap = TileMap.rows(lanes) if xmap is None else xmap
        omap = xmap if omap is None else omap
        if out is None:
            out = torch.zeros_like(x)
        else:
            self._elements(out, "out")
            if out.device != x.device:
                raise ValueError("out differs from x in device")
            if out.data_ptr() == x.data_ptr() and (out is not x or omap != xmap):
                raise ValueError("in place needs out to be x and one map")
        if not 1 <= lanes < 1 << 31:
            raise ValueError(f"ntt_base: {lanes} lanes")
        for m, buf, what in ((xmap, x, "x"), (omap, out, "out")):
            check_fields(m.fields, what)
            if m.ks < 0 or m.bound(K, lanes) > buf.shape[0]:
                raise ValueError(f"{what}: map {m} reaches past its {buf.shape[0]} rows")
        return K, lanes, xmap, out, omap

    def ntt_base_plain(self, x: torch.Tensor, pack: torch.Tensor, lanes: Optional[int] = None,
                       xmap: Optional[TileMap] = None, out: Optional[torch.Tensor] = None,
                       omap: Optional[TileMap] = None) -> torch.Tensor:
        """Plain PyTorch version of `ntt_base` (CPU tensors, and the
        reference the kernel is held to on the card)."""
        K, lanes, xmap, out, omap = self._ntt_args(x, pack, lanes, xmap, out, omap)
        logK = K.bit_length() - 1
        rev = torch.as_tensor(_bitrev_perm(logK), device=x.device)
        rows = xmap.offsets(K, lanes, x.device)[rev]           # bit-reversed
        v = words_to_limbs16(x[rows])                         # (K, lanes, L)
        tw = words_to_limbs16(pack)                           # (K, L)
        L = v.shape[-1]
        for s in range(logK):
            m, g2 = 1 << s, K >> (s + 1)
            vr = v.reshape(g2, 2, m, lanes, L)
            a, b = vr[:, 0], vr[:, 1]
            if s:                       # twiddle W^0 = 1 at t = 0 (all of stage 0)
                w = tw[m : 2 * m - 1][None, :, None, :].expand(g2, m - 1, lanes, L)
                b = torch.cat([b[:, :1], self.ops.mul(w, b[:, 1:])], dim=1)
            v = torch.stack([self.ops.add(a, b), self.ops.sub(a, b)], dim=1)
            v = v.reshape(K, lanes, L)
        out[omap.offsets(K, lanes, x.device).reshape(-1)] = limbs16_to_words(
            v.reshape(K * lanes, L))
        return out

    def ntt_base(self, x: torch.Tensor, pack: torch.Tensor, lanes: Optional[int] = None,
                 xmap: Optional[TileMap] = None, out: Optional[torch.Tensor] = None,
                 omap: Optional[TileMap] = None) -> torch.Tensor:
        """One whole K-point radix-2 DIT NTT per lane, K = pack.shape[0].

        x: (N, W) int32 canonical elements; point k of lane l (l < lanes)
        at row xmap(k, l), in NATURAL order (the bit-reversal is folded into
        the kernel's loads; the JAX kernel took bit-reversed input).
        Default: lanes = N // K and xmap = TileMap.rows(lanes), (K, lanes)
        rows.  pack: (K, W) stage-packed twiddles — entry m-1+t (m = 2^s)
        is W_K^(t << (logK-1-s)); entry m-1, W^0 = 1, is not read (its
        butterflies skip the product, as the JAX kernel does at stage 0).
        Output point k of lane l goes to row
        omap(k, l) of `out` (default: xmap; out default: a new zeroed
        buffer like x), natural order, canonical; `out` may be x itself
        with one map (in place).  Returns out."""
        K, lanes, xmap, out, omap = self._ntt_args(x, pack, lanes, xmap, out, omap)
        if x.device.type == "cpu":
            return self.ntt_base_plain(x, pack, lanes, xmap, out, omap)
        hx, ho = xmap.host(), omap.host()          # alive through the call
        self._launch("blz_ntt_base", "ntt_base", x.device, x.data_ptr(), pack.data_ptr(),
                     out.data_ptr(), K.bit_length() - 1, lanes, hx.ctypes.data,
                     ho.ctypes.data)
        return out

    # ----------------------------------------------------------------- K8
    def _mul_args(self, x, y, z, out) -> torch.Tensor:
        """Checked operands of a mul_lm call; returns the output buffer."""
        ops = [x, y] + ([z] if z is not None else [])
        for i, t in enumerate(ops):
            self._check(t, "xyz"[i])
            if t.shape != x.shape or t.device != x.device:
                raise ValueError("operands differ in shape or device")
        if out is None:
            out = torch.empty_like(x)
        else:
            self._check(out, "out")
            if out.shape != x.shape or out.device != x.device:
                raise ValueError("out differs from x in shape or device")
            # out may be x itself; y and z are read through the read-only
            # path, so out must not touch them
            nbytes = out.numel() * 4
            for t, what in ((x, "x"), (y, "y"), (z, "z")):
                if t is None or (t is x and out.data_ptr() == x.data_ptr()):
                    continue
                if nbytes and abs(out.data_ptr() - t.data_ptr()) < nbytes:
                    raise ValueError(f"out overlaps {what}")
        if x.device.type == "cuda" and x.shape[2] == 1 and any(
                t.data_ptr() % 16 for t in ops + [out]):
            raise ValueError("mul_lm: element rows (N = 1) must be 16-byte aligned")
        return out

    def mul_lm_plain(self, x: torch.Tensor, y: torch.Tensor,
                     z: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain PyTorch version of `mul_lm`."""
        out = self._mul_args(x, y, z, out)
        acc = self.ops.mul(self._limbs(x), self._limbs(y))
        if z is not None:
            acc = self.ops.mul(acc, self._limbs(z))
        return out.copy_(self._words(acc))

    def mul_lm(self, x: torch.Tensor, y: torch.Tensor,
               z: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Elementwise Montgomery product x*y (or x*y*z) of (M, W, N) batches,
        canonical, into `out` (default: a new tensor; it may be x itself, in
        place, but may not overlap y or z).  N = 1 is the element rows
        FusedNTT hands it, each element's W words together.  Returns out."""
        out = self._mul_args(x, y, z, out)
        if x.device.type == "cpu":
            return self.mul_lm_plain(x, y, z, out)
        M, _, N = x.shape
        if M and N:
            self._launch("blz_mul_lm", "mul_lm", x.device, x.data_ptr(), y.data_ptr(),
                         None if z is None else z.data_ptr(), out.data_ptr(), M, N)
        return out

    # ----------------------------------------------------------------- K9
    def _twiddle_args(self, y, t1, t2, vshift, fields, out):
        self._elements(y, "y")
        for t, what in ((t1, "t1"), (t2, "t2")):
            if t.dtype != torch.int32 or t.dim() != 3 or t.shape[2] != self.W \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: want contiguous, aligned (A, n, {self.W}) int32, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        A, J, S = t1.shape[0], t1.shape[1], t2.shape[1]
        logA, logJ, logS = _log2(A, "A"), _log2(J, "J"), _log2(S, "S")
        if t2.shape[0] != A or t1.device != y.device or t2.device != y.device:
            raise ValueError(f"twiddle_mul: t1 {tuple(t1.shape)}, t2 {tuple(t2.shape)} "
                             f"on {t1.device}, {t2.device}")
        fields = check_fields(fields, "twiddle_mul")
        if not 0 <= vshift <= 62 or field_max(fields, y.shape[0]) >> (logJ + logS):
            raise ValueError(f"twiddle_mul: fields {fields} outside the tables")
        if out is None:
            out = torch.empty_like(y)
        elif out.shape != y.shape or out.dtype != y.dtype or out.device != y.device \
                or not out.is_contiguous():
            raise ValueError("out differs from y in shape, type or device")
        return logA, logJ, logS, fields, out

    def twiddle_mul_plain(self, y: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                          vshift: int, fields, out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Plain PyTorch version of `twiddle_mul`: the table entries are
        gathered per row, then two products."""
        logA, _, logS, fields, out = self._twiddle_args(y, t1, t2, vshift, fields, out)
        v, jo, jl = twiddle_cols(y.shape[0], logA, vshift, fields, logS, y.device)
        f1 = words_to_limbs16(t1[v, jo])
        acc = self.ops.mul(f1, words_to_limbs16(y))
        f2 = words_to_limbs16(t2[v, jl])
        return out.copy_(limbs16_to_words(self.ops.mul(acc, f2)))

    def twiddle_mul(self, y: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                    vshift: int, fields, out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Inter-level twiddle: element row pos times T1[v, jo] * T2[v, jl].

        y: (N, W) canonical elements; t1: (A, J, W), t2: (A, S, W) split
        tables of elements (fused.py), A, J, S powers of two.  Row pos takes table row
        v = (pos >> vshift) % A and column j = jo * S + jl = sum over
        `fields` (src, wid, dst) of ((pos >> src) % 2^wid) << dst.  Returns
        (N, W) canonical; `out` may be y itself (in place)."""
        logA, logJ, logS, fields, out = self._twiddle_args(y, t1, t2, vshift, fields, out)
        if y.device.type == "cpu":
            return self.twiddle_mul_plain(y, t1, t2, vshift, fields, out)
        host = bit_fields_host(vshift, fields)
        self._launch("blz_twiddle_mul", "twiddle_mul", y.device, y.data_ptr(),
                     t1.data_ptr(), t2.data_ptr(), out.data_ptr(), y.shape[0], logA, logJ,
                     logS, host.ctypes.data)
        return out
