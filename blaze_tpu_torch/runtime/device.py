"""Device context — the DriverClient / shell analog.

The reference's DriverClient opens three XDMA character devices per card
slot and exposes register/DMA I/O, bitstream loading, firewalls and CMS
sensors (`blaze/src/driver_client/dclient.rs:50-151`).  On a GPU
the CUDA runtime replaces the transport; what remains useful is:

  * connection: pick a device (the slot-id analog, dclient.rs:79-86);
  * health/telemetry: device memory in place of CMS sensors and AXI
    firewall status (dclient.rs:115-151, 566-579).

The default device is `cuda`; without one the context raises.  Pass
`device="cpu"` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.errors import DeviceError


@dataclasses.dataclass
class DeviceHealth:
    """CMS-sensor analog (initialize_cms / HBM temp monitoring,
    dclient.rs:115-151)."""

    platform: str
    device_kind: str
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]

    def ok(self) -> bool:
        if self.bytes_in_use is None or self.bytes_limit in (None, 0):
            return True
        return self.bytes_in_use <= self.bytes_limit


class DeviceContext:
    """One 'connection': a torch device + telemetry."""

    def __init__(self, device_id: int = 0, device: Optional[str] = None):
        if device is None or torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise DeviceError(
                    "no CUDA device; pass device='cpu' to run the plain "
                    "PyTorch versions of the kernels"
                )
            n = torch.cuda.device_count()
            if device_id >= n:
                raise DeviceError(f"device_id {device_id} out of range ({n} devices)")
            self.device = torch.device("cuda", device_id)
        else:
            self.device = torch.device(device)
            if self.device.type != "cpu":
                raise DeviceError(f"unsupported device {device!r}")
        self.device_id = device_id

    # ------------------------------------------------------------- health
    def health(self) -> DeviceHealth:
        if self.device.type != "cuda":
            return DeviceHealth("cpu", "cpu", None, None, None)
        free, total = torch.cuda.mem_get_info(self.device)
        return DeviceHealth(
            platform="gpu",
            device_kind=torch.cuda.get_device_name(self.device),
            bytes_in_use=total - free,
            bytes_limit=total,
            peak_bytes_in_use=torch.cuda.max_memory_allocated(self.device),
        )
