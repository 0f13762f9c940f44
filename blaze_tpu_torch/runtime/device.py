"""Device context — the DriverClient / shell analog.

The reference's DriverClient opens three XDMA character devices per card
slot and exposes register/DMA I/O, bitstream loading, firewalls and CMS
sensors (`blaze/src/driver_client/dclient.rs:50-151`).  On a GPU
the CUDA runtime replaces the transport; what remains useful is:

  * connection: pick a device (the slot-id analog, dclient.rs:79-86);
  * 'binary load': build the csrc/ kernel libraries and warm a client's
    kernels up (load_binary, dclient.rs:213-236: nvcc output in place of
    bitstreams);
  * health/telemetry: device memory and the caching allocator's live
    blocks in place of CMS sensors and AXI firewall status
    (dclient.rs:115-151, 566-579), and a torch.profiler trace in place of
    the hardware perf counters (msm_hw_code.rs:35-54).

  * the mesh: `num_devices` and `make_mesh`, a named
    torch.distributed DeviceMesh for the sharded paths (dist/).

The default device is `cuda`; without one the context raises.  Pass
`device="cpu"` to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from .. import _build
from ..utils.errors import DeviceError, LoadFailed

TRACE_FILE = "trace.json"      # what `profile` writes into its trace_dir


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

    # --------------------------------------------------------------- mesh
    @property
    def num_devices(self) -> int:
        """The CUDA devices this process sees on a card, 1 on the CPU."""
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def make_mesh(self, shape: dict):
        """Named mesh of this context's device type, e.g. {'dp': 4, 'sp': 2}
        (dist.make_mesh): a DeviceMesh whose mesh_dim_names are the keys.
        Raises ValueError when it wants more ranks than the process group
        has (one process per card; without a group, a group of one)."""
        from ..dist.mesh import make_mesh

        return make_mesh(shape, device_type=self.device.type)

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

    def live_buffers(self) -> int:
        """Firewall-status analog: the caching allocator's active blocks on
        this device (allocations not yet freed); -1 on the CPU, which keeps
        no such count (the JAX version's answer when it cannot count)."""
        if self.device.type != "cuda":
            return -1
        return int(torch.cuda.memory_stats(self.device).get("active.all.current", 0))

    # ----------------------------------------------------------- profiler
    @contextlib.contextmanager
    def profile(self, trace_dir):
        """Profile a block with torch.profiler (CPU activity, and CUDA on a
        card, which is synchronised before the block ends) and write its
        Chrome/Perfetto trace to `trace_dir`/trace.json (TRACE_FILE): per-
        kernel device times, the analog of the reference's hardware perf
        counters (per-phase busy/total clocks, msm_hw_code.rs:35-54).
        Yields the profiler, for its key_averages():

            with ctx.profile("build/msm_trace") as prof:
                client.start_process(); client.wait_result()
        """
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(str(out / TRACE_FILE))

    # ---------------------------------------------------------- 'binary'
    def load_binary(self, warmup_fns: Sequence) -> float:
        """Build the csrc/ kernel libraries (on a card; the CPU runs the
        plain versions) and call each zero-argument warm-up, synchronising
        after it: the bitstream-load analog.  Returns the wall seconds
        (dclient.rs:213-236); a failed build or warm-up raises LoadFailed."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            try:
                _build.build_all()
            except OSError as e:
                raise LoadFailed(f"kernel build failed: {e}") from e
        for fn in warmup_fns:
            try:
                fn()
                if cuda:
                    torch.cuda.synchronize(self.device)
            except Exception as e:
                raise LoadFailed(
                    f"kernel warm-up failed for {getattr(fn, '__name__', fn)}: {e}"
                ) from e
        return time.perf_counter() - t0
