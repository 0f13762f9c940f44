"""ctypes binding of the host codec (csrc/codec.cpp), built with g++ at first
use (_build.py, into the git-ignored build/ directory).

Port of blaze_tpu/native/codec.py.  The JAX package loads a library that
`make -C csrc` may have built and falls back to numpy without it; here the
library is built on first use, and a failed build raises LoadFailed instead
of dropping to numpy.  fields/codec.py takes this path for buffers from
_NATIVE_MIN_BYTES up and keeps numpy below it.  Left out: to_blocked /
from_blocked, the TPU's blocked-tile layout.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import _build
from ..utils.errors import DataError, LoadFailed

__all__ = ["have_native", "bytes_to_limbs", "limbs_to_bytes", "bank_split", "bank_merge",
           "transpose"]

_c = ctypes
_ARGTYPES = {
    "blz_bytes_to_limbs": [_c.c_void_p, _c.c_void_p, _c.c_size_t, _c.c_int],
    "blz_limbs_to_bytes": [_c.c_void_p, _c.c_void_p, _c.c_size_t, _c.c_int],
    "blz_bank_split": [_c.c_void_p, _c.c_void_p, _c.c_size_t, _c.c_int, _c.c_int],
    "blz_bank_merge": [_c.c_void_p, _c.c_void_p, _c.c_size_t, _c.c_int, _c.c_int],
    "blz_transpose": [_c.c_void_p, _c.c_void_p, _c.c_size_t, _c.c_size_t, _c.c_int],
}


def _fn(name: str):
    fn = getattr(_build.load("codec"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = None
    return fn


def have_native() -> bool:
    """Whether the host codec's library is built and loads (building it on
    first use); False where it cannot be, instead of LoadFailed."""
    try:
        _build.load("codec")
    except LoadFailed:
        return False
    return True


def _u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)


def _check_elem(nbytes: int, size: int, what: str) -> None:
    if nbytes < 2 or nbytes % 2 or size % nbytes:
        raise DataError(f"{what}: {size} bytes are not whole elements of {nbytes} bytes")


def bytes_to_limbs(data, nbytes: int) -> np.ndarray:
    """LE element bytes -> uint32[n, nbytes // 2] 16-bit limbs."""
    src = _u8(data)
    _check_elem(nbytes, src.size, "bytes_to_limbs")
    n = src.size // nbytes
    dst = np.empty((n, nbytes // 2), dtype=np.uint32)
    _fn("blz_bytes_to_limbs")(src.ctypes.data, dst.ctypes.data, n, nbytes)
    return dst


def limbs_to_bytes(limbs: np.ndarray, nbytes: int) -> bytes:
    """uint32 16-bit limbs, nbytes // 2 per element -> LE element bytes."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint32).reshape(-1)
    _check_elem(nbytes, 2 * arr.size, "limbs_to_bytes")
    n = 2 * arr.size // nbytes
    dst = np.empty(n * nbytes, dtype=np.uint8)
    _fn("blz_limbs_to_bytes")(arr.ctypes.data, dst.ctypes.data, n, nbytes)
    return dst.tobytes()


def bank_split(data, elem_bytes: int, nbanks: int = 16) -> list[bytes]:
    """Strided bank layout (the reference's 16-HBM-bank preprocess analog):
    element i to bank i % nbanks, slot i // nbanks."""
    src = _u8(data)
    if elem_bytes < 1 or nbanks < 1 or src.size % elem_bytes:
        raise DataError(f"bank_split: {src.size} bytes, element {elem_bytes}, {nbanks} banks")
    n = src.size // elem_bytes
    if n % nbanks:
        raise ValueError(f"{n} elements not divisible by {nbanks} banks")
    dst = np.empty(src.size, dtype=np.uint8)
    _fn("blz_bank_split")(src.ctypes.data, dst.ctypes.data, n, elem_bytes, nbanks)
    per = (n // nbanks) * elem_bytes
    raw = dst.tobytes()
    return [raw[i * per:(i + 1) * per] for i in range(nbanks)]


def bank_merge(banks: list[bytes], elem_bytes: int) -> bytes:
    """Inverse of bank_split."""
    nbanks = len(banks)
    if nbanks < 1 or elem_bytes < 1 or len({len(b) for b in banks}) != 1 \
            or len(banks[0]) % elem_bytes:
        raise DataError(f"bank_merge: {nbanks} banks of unequal or partial elements")
    src = np.frombuffer(b"".join(banks), dtype=np.uint8)
    n = src.size // elem_bytes
    dst = np.empty(src.size, dtype=np.uint8)
    _fn("blz_bank_merge")(src.ctypes.data, dst.ctypes.data, n, elem_bytes, nbanks)
    return dst.tobytes()


def transpose(data, rows: int, cols: int, elem_bytes: int) -> bytes:
    """(rows, cols) matrix of elem_bytes elements -> its (cols, rows)
    transpose, as bytes."""
    src = _u8(data)
    if min(rows, cols, elem_bytes) < 0 or src.size != rows * cols * elem_bytes:
        raise DataError(f"transpose: {src.size} bytes are not ({rows}, {cols}) elements "
                        f"of {elem_bytes} bytes")
    dst = np.empty(src.size, dtype=np.uint8)
    _fn("blz_transpose")(src.ctypes.data, dst.ctypes.data, rows, cols, elem_bytes)
    return dst.tobytes()
