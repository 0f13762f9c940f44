"""MSM.msm_precomputed on resident multiples in a closed loop: blaze's
precompute mode.  In set-up the unique bases are expanded by the program
(precompute_resident) into their `msm_precompute_factor` multiples and
tiled multiple-major to factor * n resident columns; each job is one MSM of
n bases over one unsliced (Ls, n) scalar set in turn, done when its result
is ready on the device.  The judgement is MSMJob's: the class sums of the
unsliced scalars over the unique bases, whatever multiples the program
kept."""
from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from zkbench import faults, jobs, work
from zkbench.loops import msm_resident
from zkbench.reference import bn254  # noqa: F401  (adds BN254 to the reference's curves)
from zkbench.reference.fields import ints_to_words, nwords


class Loop(msm_resident.Loop):
    """msm_resident's loop (its window and finish) with `self.msm` the
    precomputed MSM over the multiples."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.factor = int(cfg["msm_precompute_factor"])
        per = -(-self.g1.r.bit_length() // self.factor)
        self.slice_bits = -(-per // 16) * 16        # whole 16-bit limbs per multiple

    def work(self):
        """The MSM the card runs: factor * n points of slice_bits-bit
        scalars (blaze's 8x mode on BN254: msm_work(8 n, 16, 8, 32, 2))."""
        return work.msm_work(self.factor * self.n, int(self.cfg["msm_window_bits"]),
                             nwords(self.g1.p), self.slice_bits, self.slice_bits // 16)

    def setup(self):
        # first, before anything is allocated: a program without the
        # resident precomputed form fails here, in seconds
        from blaze_tpu_torch.msm import precompute_resident
        from blaze_tpu_torch.curves import CURVES, Curve
        from blaze_tpu_torch.msm import MSM, points_to_resident

        cv = Curve(CURVES[self.curve])
        W, k, U = nwords(self.g1.p), self.factor, self.U
        xy = ints_to_words([c for pt in self.make_points() for c in pt], W)
        pts = torch.from_numpy(xy.view(np.int32).reshape(U, 2, W)).to(self.device)
        mult = precompute_resident(cv, points_to_resident(cv, pts), k)      # (2W, k U)
        self.resident = (mult.reshape(2 * W, k, 1, U).expand(2 * W, k, self.n // U, U)
                         .reshape(2 * W, k * self.n))
        del mult
        self.make_scalars()
        engine = MSM(cv)
        self.msm = lambda points, scalars: engine.msm_precomputed(points, scalars, k)
        # four rounds over the sets: a process's first MSMs run slower,
        # while the card launches the chunk graphs' kernels slower
        for s in range(4 * self.sets):
            self.msm(self.resident, self.scalars[s % self.sets])
        jobs.sync(self.device)
        self.outs = []


def _msm():
    from blaze_tpu_torch.msm import MSM

    return MSM


def _after(after):
    """msm_precomputed's result through after(result, args): the hooks of
    msm_resident's faults, planted on the precomputed form."""
    return faults.wrap(_msm(), "msm_precomputed", after)


def control(job):
    """The MSM's projective result with X left lazy (X + p)."""
    p = job.g1.p

    def after(out, _):
        out = out.clone()
        out[0] = faults.lazy(out[0], p)
        return out

    return _after(after)


def stale(job):
    """Every MSM after the first returns the state it held: the result of
    the call before it."""
    last = []

    def after(out, _):
        last.append(out)
        return last[-2].clone() if len(last) > 1 else out

    return _after(after)


def half(job):
    """The MSM over the first half of the bases only: the scalars of the
    second half zeroed (a copy of the set, not of the multiples)."""
    orig = _msm().msm_precomputed

    def first_half(self, expanded, scalars, *a, **k):
        kept = scalars.clone()
        kept[:, scalars.shape[1] // 2:] = 0
        return orig(self, expanded, kept, *a, **k)

    return mock.patch.object(_msm(), "msm_precomputed", first_half)


def altered(job):
    """The result's lowest X word changed by one."""
    def after(out, _):
        out = out.clone()
        out[0, 0] ^= 1
        return out

    return _after(after)


FAULTS = {"unchanged": stale, "half": half, "altered": altered}
