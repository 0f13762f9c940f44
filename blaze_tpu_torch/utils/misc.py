"""Small host-side helpers — the reference's `utils.rs` surface.

`retry` mirrors the generic N-attempt/1 s-backoff combinator
(`blaze/src/utils.rs:133-147`); `elide_payload` mirrors the
size-aware logging macros that hide payloads >= 256 bytes
(`blaze/src/utils.rs:9-37`).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

import torch

log = logging.getLogger("blaze_tpu_torch")

_ELIDE_AT = 256  # bytes; utils.rs:9-37 threshold

T = TypeVar("T")


def retry(fn: Callable[[], T], times: int = 3, sleep_s: float = 1.0,
          exceptions=(Exception,)) -> T:
    """Call `fn` up to `times` times, sleeping `sleep_s` between attempts
    (utils.rs:133-147: N attempts, 1 s backoff). Raises the last error."""
    last: BaseException | None = None
    for attempt in range(times):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 — deliberate retry loop
            last = e
            log.warning("retry %d/%d failed: %s", attempt + 1, times, e)
            if attempt + 1 < times:
                time.sleep(sleep_s)
    raise last


def hard_sync(x: torch.Tensor) -> None:
    """Execution barrier for the device holding `x` — the RESULT_VALID-poll
    analog (msm_api.rs:222-238) every client's wait_result goes through.
    CPU tensors are already materialised."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def elide_payload(data, max_len: int = _ELIDE_AT) -> str:
    """Loggable repr of a payload, eliding bodies >= max_len bytes
    (the getter_log!/setter_log! behavior, utils.rs:9-37)."""
    try:
        n = len(data)
    except TypeError:
        return repr(data)
    if n >= max_len:
        return f"<{type(data).__name__} of {n} bytes>"
    return repr(data)
