from .errors import (
    BlazeError,
    DataError,
    DeviceError,
    InvalidPrimitiveParam,
    LoadFailed,
    NotReady,
)
from .misc import elide_payload, hard_sync, retry

__all__ = [
    "BlazeError",
    "DataError",
    "DeviceError",
    "InvalidPrimitiveParam",
    "LoadFailed",
    "NotReady",
    "elide_payload",
    "hard_sync",
    "retry",
]
