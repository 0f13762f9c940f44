"""K1: batched canonical Montgomery product (csrc/montmul.cu).

Replaces blaze_tpu/fields/mxu.py MXUMont.mul2d (via mont_mul_mxu), which
Field.mul reaches on the TPU.  Operands are (M, W) int32 word tensors in
Montgomery form, < p; the product is < p.

`mont_mul` launches the CUDA kernel for CUDA tensors and runs `mont_mul_plain`
— the same function on 16-bit int64 limbs (fields/kernel_ops.py) — only for
CPU tensors.  Bound and design: see csrc/montmul.cu.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .kernel_ops import PlainFieldOps, consts_host, limbs16_to_words, words_to_limbs16
from .spec import FieldSpec

_CONSTS: dict = {}
_PLAIN: dict = {}


def _consts(spec: FieldSpec) -> np.ndarray:
    c = _CONSTS.get(spec.name)
    if c is None:
        c = _CONSTS[spec.name] = consts_host(spec)
    return c


def _entry():
    fn = _build.load("montmul").blz_mont_mul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, W) x (M, W) int32 words."""
    ops = _PLAIN.get(spec.name)
    if ops is None:
        ops = _PLAIN[spec.name] = PlainFieldOps(spec, lazy=False)
    return limbs16_to_words(ops.mul(words_to_limbs16(a), words_to_limbs16(b)))


def _check_operand(x: torch.Tensor, W: int, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != W:
        raise ValueError(f"{what}: want (M, {W}) int32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical Montgomery product of (M, W) int32 word batches."""
    W = spec.nwords
    _check_operand(a, W, "a")
    _check_operand(b, W, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("operands differ in shape or device")
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    consts = _consts(spec)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry()(W, consts.ctypes.data, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), a.shape[0], stream)
    _build.check(rc, "blz_mont_mul")
    _build.LAUNCHES["mont_mul"] += 1
    return out
