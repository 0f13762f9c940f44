from .primitive import DriverPrimitive, ImageParams, PhaseTimings
from .device import DeviceContext, DeviceHealth
from .clients import (
    MSMClient,
    MSMInit,
    MSMParams,
    MSMInput,
    MSMResult,
    NTTClient,
    NTTInit,
    NTTInput,
    PoseidonClient,
    PoseidonInitializeParameters,
    PoseidonResult,
)

__all__ = [
    "DriverPrimitive",
    "ImageParams",
    "PhaseTimings",
    "DeviceContext",
    "DeviceHealth",
    "MSMClient",
    "MSMInit",
    "MSMParams",
    "MSMInput",
    "MSMResult",
    "NTTClient",
    "NTTInit",
    "NTTInput",
    "PoseidonClient",
    "PoseidonInitializeParameters",
    "PoseidonResult",
]
