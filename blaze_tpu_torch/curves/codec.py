"""Point wire formats matching the reference's DMA byte contracts.

* affine input points:  x || y, little-endian coords
  (`blaze/tests/msm/mod.rs:118-124` builds exactly this layout);
* projective results:   z || y || x, little-endian coords
  (`blaze/tests/msm/mod.rs:397-399` parses [0..48]=z, [48..96]=y,
  [96..144]=x for BLS12-381; same order for the other curves).

Coordinates on the wire are canonical (non-Montgomery) integers.  Decoded
coordinates are 32-bit words (fields/codec.py), scalars 16-bit limbs.
"""
from __future__ import annotations

import numpy as np

from ..fields.codec import (
    bytes_to_limbs,
    bytes_to_words,
    limbs_to_bytes,
    words_to_bytes,
)
from ..utils.errors import DataError
from .spec import CurveSpec


def decode_affine_points(data: bytes | np.ndarray, spec: CurveSpec) -> np.ndarray:
    """x||y LE bytes -> uint32[N, 2, W] canonical words."""
    words = bytes_to_words(data, spec.fq)
    if words.shape[0] % 2:
        raise DataError("odd number of coordinates")
    return words.reshape(-1, 2, spec.fq.nwords)


def encode_affine_points(points: np.ndarray, spec: CurveSpec) -> bytes:
    """Canonical affine points -> x||y LE bytes.  They may come as the
    reference's (N, 2, L) 16-bit limbs (blaze_tpu's get_data_from_hbm) or as
    (N, 2, W) 32-bit words: the last axis says which (L = 2W)."""
    arr = np.asarray(points)
    if arr.ndim and arr.shape[-1] == spec.fq.nlimbs:
        return limbs_to_bytes(arr, spec.fq)
    return words_to_bytes(arr, spec.fq)


def decode_scalars(data: bytes | np.ndarray, spec: CurveSpec) -> np.ndarray:
    """LE scalar bytes -> uint32[N, Ls] 16-bit limbs."""
    return bytes_to_limbs(data, spec.fr)


def encode_scalars(scalars: np.ndarray, spec: CurveSpec) -> bytes:
    return limbs_to_bytes(np.asarray(scalars), spec.fr)


def encode_projective_result(point: np.ndarray, spec: CurveSpec) -> bytes:
    """uint32[3, W] canonical (X, Y, Z) words -> z||y||x LE bytes."""
    pt = np.asarray(point).reshape(3, spec.fq.nwords)
    return words_to_bytes(np.stack([pt[2], pt[1], pt[0]]), spec.fq)


def decode_projective_result(data: bytes, spec: CurveSpec) -> np.ndarray:
    """z||y||x LE bytes -> uint32[3, W] canonical (X, Y, Z) words."""
    words = bytes_to_words(data, spec.fq).reshape(3, spec.fq.nwords)
    return np.stack([words[2], words[1], words[0]])
