"""Byte codecs: little-endian element bytes <-> limb and word arrays.

Wire formats follow the reference contracts: every element is a fixed-width
little-endian byte string — 32 B scalars for all curves, 48 B base-field
coordinates for BLS12-377/381, 32 B for BN254
(`blaze/src/ingo_msm/msm_cfg.rs:44-92`).

A little-endian byte string is at once the memory image of its 16-bit limbs
and of its 32-bit words, so both codecs are numpy views: field elements
(point coordinates) decode to 32-bit words, the port's device form;
scalars decode to 16-bit limbs, the form the MSM's digit extraction reads.
From _NATIVE_MIN_BYTES up, the limb codecs run the host codec
(native/codec.py, csrc/codec.cpp), as the JAX package's do; its build
failing raises LoadFailed.
"""
from __future__ import annotations

import numpy as np

from ..native import codec as _native
from ..utils.errors import DataError
from .spec import FieldSpec

# Below this, numpy's vectorized astype wins over the ctypes call overhead.
_NATIVE_MIN_BYTES = 1 << 22


def _as_u8(data: bytes | np.ndarray, spec: FieldSpec) -> np.ndarray:
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.asarray(data, dtype=np.uint8)
    if buf.size % spec.nbytes:
        raise DataError(
            f"buffer size {buf.size} not a multiple of element size "
            f"{spec.nbytes} ({spec.name})"
        )
    return np.ascontiguousarray(buf)


def bytes_to_limbs(data: bytes | np.ndarray, spec: FieldSpec) -> np.ndarray:
    """LE bytes (N * nbytes) -> uint32[N, nlimbs] 16-bit limbs."""
    buf = _as_u8(data, spec)
    if buf.size >= _NATIVE_MIN_BYTES:
        return _native.bytes_to_limbs(buf, spec.nbytes)
    return buf.view("<u2").reshape(-1, spec.nlimbs).astype(np.uint32)


def limbs_to_bytes(limbs: np.ndarray, spec: FieldSpec) -> bytes:
    """uint32[..., nlimbs] 16-bit limbs -> LE bytes."""
    arr = np.asarray(limbs, dtype=np.uint32).reshape(-1, spec.nlimbs)
    if arr.nbytes >= 2 * _NATIVE_MIN_BYTES:
        return _native.limbs_to_bytes(arr, spec.nbytes)
    return arr.astype("<u2").tobytes()


def bytes_to_words(data: bytes | np.ndarray, spec: FieldSpec) -> np.ndarray:
    """LE bytes (N * nbytes) -> uint32[N, nwords] 32-bit words."""
    return _as_u8(data, spec).view("<u4").reshape(-1, spec.nwords).astype(
        np.uint32
    )


def words_to_bytes(words: np.ndarray, spec: FieldSpec) -> bytes:
    """uint32[..., nwords] 32-bit words -> LE bytes."""
    arr = np.asarray(words).astype("<u4").reshape(-1, spec.nwords)
    return arr.tobytes()
