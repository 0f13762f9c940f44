"""KF: the Field's elementwise ops on the card (csrc/field_ew.cu).

`field_ew(spec, op, a, b)` computes one of OPS on int32 word tensors
(..., W), canonical Montgomery values < p, W = 8 or 12:

  add     a + b mod p        sub     a - b mod p
  neg     -a mod p           double  2a mod p
  canon   a - p where top * 2^(32W) + a >= p, else a: b is the carry word
          `top` (..., ) or None (no carry: brings a lazy value < 2p to < p)

These are blaze_tpu/fields/mont.py Field.add / sub / neg / double /
_cond_sub_p, which the JAX package leaves to XLA's fused elementwise ops;
in the port they are the port's own kernel, KF (no pallas_call to replace).
The operands broadcast as torch's do.

A CUDA tensor launches KF (launch counter `field_ew`); a CPU tensor runs
`field_ew_plain`, the same function on int64 copies of the words with
Kogge-Stone carry lookahead (fields/kernel_ops.py), which equals
blaze_tpu's Field op for op on any input words.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel_ops import cond_sub, field_consts, normalize, sub_limbs, words_i32, words_u64
from .spec import FieldSpec

OPS = ("add", "sub", "neg", "double", "canon")   # csrc/field_ew.cuh FieldEwOp
_BINARY = ("add", "sub")

_P64: dict = {}


def _p64(spec: FieldSpec, device) -> torch.Tensor:
    """(W,) int64 words of p on `device` (the plain version's modulus)."""
    key = (spec.name, str(device))
    t = _P64.get(key)
    if t is None:
        t = _P64[key] = words_u64(torch.as_tensor(field_consts(spec)[: spec.nwords]
                                                  .view("int32"), device=device))
    return t


def field_ew_plain(spec: FieldSpec, op: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (CPU tensors, and the reference
    the kernel is held to on the card)."""
    p = _p64(spec, a.device)
    if op == "add" or op == "double":
        limbs, top = normalize(words_u64(a) + words_u64(a if op == "double" else b), 32)
        return words_i32(cond_sub(limbs, top, p, 32))
    if op == "sub":
        d, borrow = sub_limbs(words_u64(a), words_u64(b), 32)
        # if borrowed, add p back (cannot re-borrow since p - (b - a) > 0)
        fixed, _ = normalize(d + p, 32)
        return words_i32(torch.where((borrow > 0)[..., None], fixed, d))
    if op == "neg":
        d, _ = sub_limbs(p, words_u64(a), 32)
        return torch.where((a == 0).all(dim=-1)[..., None], a, words_i32(d))
    top = (torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device) if b is None
           else (b != 0).to(torch.int64))
    return words_i32(cond_sub(words_u64(a), top, p, 32))


def _entry():
    fn = _build.load("field_ew").blz_field_ew
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operand_shape(spec: FieldSpec, op: str, a: torch.Tensor, b) -> torch.Size:
    """The broadcast (..., W) shape of the call; raises ValueError on an op,
    dtype, width, device or shape the kernel does not take."""
    W = spec.nwords
    if op not in OPS:
        raise ValueError(f"field op {op!r}: want one of {OPS}")
    if W not in (8, 12):
        raise ValueError(f"{spec.name}: KF is built for W = 8 and 12, not {W}")
    if a.dtype != torch.int32 or a.dim() < 1 or a.shape[-1] != W:
        raise ValueError(f"a: want (..., {W}) int32, got {tuple(a.shape)} {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if op in _BINARY:
        if b is None or b.dtype != torch.int32 or b.dim() < 1 or b.shape[-1] != W:
            got = None if b is None else f"{tuple(b.shape)} {b.dtype}"
            raise ValueError(f"b: want (..., {W}) int32, got {got}")
    elif op == "canon" and b is not None and b.dtype.is_floating_point:
        raise ValueError(f"top: want an integer tensor, got {b.dtype}")
    if b is None or op in ("neg", "double"):
        return a.shape
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    try:
        if op == "canon":
            return torch.Size((*torch.broadcast_shapes(a.shape[:-1], b.shape), W))
        return torch.broadcast_shapes(a.shape, b.shape)
    except RuntimeError as e:
        raise ValueError(f"operands do not broadcast: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}") from e


def field_ew(spec: FieldSpec, op: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """One of OPS over (..., W) int32 words (see the module's docstring)."""
    shape = _operand_shape(spec, op, a, b)
    if a.device.type == "cpu":
        return field_ew_plain(spec, op, a, b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    a2 = a.expand(shape).contiguous()
    b2 = top = None
    if op in _BINARY:
        b2 = b.expand(shape).contiguous()
    elif op == "canon" and b is not None:
        top = (b != 0).to(torch.int32).expand(shape[:-1]).contiguous()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry()(spec.nwords, field_consts(spec).ctypes.data, OPS.index(op),
                      a2.data_ptr(), None if b2 is None else b2.data_ptr(),
                      None if top is None else top.data_ptr(), out.data_ptr(),
                      out.numel() // spec.nwords, stream)
    _build.check(rc, "blz_field_ew")
    _build.LAUNCHES["field_ew"] += 1
    return out
