"""What the controls and the planted faults share.

Each job loop (`loops/<job>.py`) defines `control(job)` and `FAULTS`:
functions that, given the job object, return a context manager which
breaks the program underneath the timed path.  The benchmark's own runs
never use them; the tests run every one at a small size on the CPU, and
control.py runs them on the card at the cell's own size.

The control breaks the guarantee every configuration states, canonical
outputs: each output element is left in the lazy range [p, 2p) instead of
[0, p), the final subtraction a Montgomery kernel might be tempted to skip.
The faults are a step that returns its state unchanged, half of the batch
left out, and one answer altered where it is produced (there is no
exchange between chips on one card).
"""
from __future__ import annotations

from unittest import mock

import numpy as np
import torch


def lazy(words: torch.Tensor, p: int) -> torch.Tensor:
    """(..., W) int32 words of canonical values -> the same values plus p,
    word by word with carries (p < 2^(32 W - 1), so the sum fits)."""
    out = torch.empty_like(words)
    carry = torch.zeros_like(words[..., 0], dtype=torch.int64)
    for i in range(words.shape[-1]):
        s = (words[..., i].to(torch.int64) & 0xFFFFFFFF) + ((p >> (32 * i)) & 0xFFFFFFFF) + carry
        out[..., i] = (s & 0xFFFFFFFF).to(torch.int32)
        carry = s >> 32
    return out


def lazy_words(words: np.ndarray, p: int) -> np.ndarray:
    """lazy() on host words (any 32-bit dtype), as uint32."""
    t = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    return lazy(t, p).numpy().view(np.uint32)


def wrap(obj, name: str, after):
    """Patch obj.name so that its result goes through after(result, args)."""
    orig = getattr(obj, name)

    def wrapped(*args, **kwargs):
        return after(orig(*args, **kwargs), args)

    return mock.patch.object(obj, name, wrapped)
