"""MSM.__call__ on resident bases in a closed loop: the points made once
in set-up and made resident (points_to_resident), one scalar set per job
in turn, each job done when its result is ready on the device."""
from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from zkbench import faults, jobs
from zkbench.reference.fields import ints_to_words, nwords, words_to_ints


class Loop(jobs.MSMJob):
    libs = ("montmul", "field_ew", "ec_kernels")

    def setup(self):
        from blaze_tpu_torch.curves import CURVES, Curve
        from blaze_tpu_torch.msm import MSM, points_to_resident

        cv = Curve(CURVES[self.curve])
        W = nwords(self.g1.p)
        xy = ints_to_words([c for pt in self.make_points() for c in pt], W)
        pts = torch.from_numpy(xy.view(np.int32).reshape(self.U, 2, W)).to(self.device)
        self.resident = points_to_resident(cv, pts).repeat(1, self.n // self.U)
        self.make_scalars()
        self.msm = MSM(cv)
        for s in range(self.sets):
            self.msm(self.resident, self.scalars[s])
        jobs.sync(self.device)
        self.outs = []

    def window(self, stop):
        def job(j):
            out = self.msm(self.resident, self.scalars[j % self.sets])
            jobs.sync(self.device)
            self.outs.append(out)

        return jobs.closed_loop(job, stop)

    def finish(self):
        self.results = [words_to_ints(o.cpu().numpy()) for o in self.outs]
        del self.outs, self.msm, self.resident


def _msm():
    from blaze_tpu_torch.msm import MSM

    return MSM


def control(job):
    """The MSM's projective result with X left lazy (X + p)."""
    p = job.g1.p

    def after(out, _):
        out = out.clone()
        out[0] = faults.lazy(out[0], p)
        return out

    return faults.wrap(_msm(), "__call__", after)


def stale(job):
    """Every MSM after the first returns the state it held: the result of
    the call before it."""
    last = []

    def after(out, _):
        last.append(out)
        return last[-2].clone() if len(last) > 1 else out

    return faults.wrap(_msm(), "__call__", after)


def half(job):
    """The MSM over the first half of the points only."""
    MSM = _msm()
    orig = MSM.__call__

    def first_half(self, points, scalars, *a, **k):
        n = points.shape[1] // 2
        return orig(self, points[:, :n], scalars[:, :n], *a, **k)

    return mock.patch.object(MSM, "__call__", first_half)


def altered(job):
    """The result's lowest X word changed by one."""
    def after(out, _):
        out = out.clone()
        out[0, 0] ^= 1
        return out

    return faults.wrap(_msm(), "__call__", after)


FAULTS = {"unchanged": stale, "half": half, "altered": altered}
