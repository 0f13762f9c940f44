"""Five-phase primitive lifecycle — the DriverPrimitive trait analog.

The reference's uniform client API (`blaze/src/driver_client/
dclient.rs:24-46`):

    new(ptype, dclient) -> loaded_binary_parameters() -> initialize(param)
    -> set_data(input) -> start_process(param) -> wait_result()
    -> result(param) -> Option<O>

is kept verbatim as the framework's client-facing shape, mapped onto a CUDA
stream: `start_process` issues the MSM's kernels on the current stream,
`wait_result` synchronizes the device, `result` marshals back to wire
format.  Task labels and the pending queue
mirror msm_hw_code.rs:19-25; phase timings mirror the HW perf-counter
surface (msm_hw_code.rs:35-54).
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import time
from typing import Any, Optional


@dataclasses.dataclass
class ImageParams:
    """Build metadata of the loaded 'image' — here the built kernels.

    Mirrors ParametersAPI/parse_image_params (dclient.rs:17-22,
    msm_api.rs:333-379): the reference packs curve/adder/segment counts
    into a u32; we expose the analogous plan facts.
    """

    primitive: str
    fields: dict

    def debug_information(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in self.fields.items())
        return f"[{self.primitive}] {kv}"


@dataclasses.dataclass
class PhaseTimings:
    """Wall-clock per lifecycle phase (the RunResults analog,
    tests/integration_msm.rs:265-282)."""

    set_data_s: float = 0.0
    start_s: float = 0.0
    wait_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.set_data_s + self.start_s + self.wait_s


class DriverPrimitive(abc.ABC):
    """Uniform lifecycle every primitive client implements."""

    def __init__(self):
        self._task_labels = collections.deque()
        self._next_label = 0
        self._timings = PhaseTimings()

    # ------------------------------------------------------------- queue
    @property
    def task_label(self) -> int:
        """Label of the most recently pushed task (msm_api.rs:278-283)."""
        return self._next_label

    @property
    def pending_tasks(self) -> int:
        """Queue depth (NOF_TASKS_PENDING analog, msm_hw_code.rs:24)."""
        return len(self._task_labels)

    def _push_task(self) -> int:
        label = self._next_label
        self._task_labels.append(label)
        self._next_label += 1
        return label

    def _pop_task(self) -> Optional[int]:
        """POP the completed result's label (RESULT label + pop,
        msm_api.rs:260-269)."""
        return self._task_labels.popleft() if self._task_labels else None

    @property
    def timings(self) -> PhaseTimings:
        return self._timings

    # ----------------------------------------------------------- lifecycle
    @abc.abstractmethod
    def loaded_binary_parameters(self) -> ImageParams:
        ...

    @abc.abstractmethod
    def initialize(self, param) -> None:
        ...

    @abc.abstractmethod
    def set_data(self, input) -> None:
        ...

    @abc.abstractmethod
    def start_process(self, param=None) -> None:
        ...

    @abc.abstractmethod
    def wait_result(self) -> None:
        ...

    @abc.abstractmethod
    def result(self, param=None) -> Optional[Any]:
        ...


class timed:
    """Context manager accumulating wall time into a PhaseTimings field."""

    def __init__(self, timings: PhaseTimings, field: str):
        self.timings = timings
        self.field = field

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        setattr(
            self.timings,
            self.field,
            getattr(self.timings, self.field) + time.perf_counter() - self.t0,
        )
        return False
