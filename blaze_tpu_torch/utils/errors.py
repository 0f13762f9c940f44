"""Typed error hierarchy — the `DriverClientError` analog.

The reference defines one thiserror enum wrapping I/O failures, readiness
gates and bad parameters plus a crate-wide Result alias
(`blaze/src/error.rs:4-32`).  Python exceptions play both roles;
the variants map 1:1 where the concept survives the move to a GPU:

  WriteError/ReadError (io + offset)  -> DeviceError (wraps the CUDA/torch error)
  HBICAPNotReady                      -> NotReady (engine busy / buffer empty)
  InvalidPrimitiveParam               -> InvalidPrimitiveParam
  LoadFailed (bitstream)              -> LoadFailed (kernel build / warm-up)
  CsvError / FileError                -> DataError
  Unknown                             -> BlazeError (base)
"""
from __future__ import annotations


class BlazeError(Exception):
    """Base class for all framework errors (error.rs:4 analog)."""


class DeviceError(BlazeError, RuntimeError):
    """Device transfer / execution failure (error.rs Write/Read analogs).

    Carries the logical buffer name in place of the reference's register
    offset (`error.rs:7-14`)."""

    def __init__(self, msg: str, *, buffer: str | None = None):
        super().__init__(msg if buffer is None else f"{msg} (buffer: {buffer})")
        self.buffer = buffer


class NotReady(BlazeError, RuntimeError):
    """Operation attempted before the engine/buffer is ready
    (HBICAPNotReady analog, error.rs:16-17)."""


class InvalidPrimitiveParam(BlazeError, ValueError):
    """Bad lifecycle parameter (error.rs:19-20)."""


class LoadFailed(BlazeError, RuntimeError):
    """Kernel build / warm-up failure (bitstream LoadFailed analog,
    error.rs:25-26)."""


class DataError(BlazeError, ValueError):
    """Malformed input bytes (CsvError + FileError analogs,
    error.rs:22-23,28-29)."""
