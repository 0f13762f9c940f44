"""FusedNTT.ntt in a closed loop on inputs already on the device, one
input set per job in turn; the output is the caller's on the device, and
a job is done when it is ready there."""
from __future__ import annotations

from unittest import mock

import torch

from zkbench import faults, jobs


class Loop(jobs.NTTJob):
    libs = ("montmul", "field_ew", "ntt_kernels")

    def setup(self):
        from blaze_tpu_torch.fields import FIELDS
        from blaze_tpu_torch.ntt import FusedNTT

        self.plan = FusedNTT(FIELDS[self.field], self.logn, device=self.device)
        self.x = [self.make_input(s) for s in range(self.sets)]
        self.idx_dev = [torch.tensor(i, device=self.device) for i in self.idx]
        # as many outputs alive at once as the window holds (the kept, each
        # set's last, the current), so that its jobs find them in the
        # allocator's cache and none allocates device memory
        held = [self.plan.ntt(self.x[j % self.sets])
                for j in range(len(self.keep) + self.sets + 1)]
        jobs.sync(self.device)
        del held
        self.rows, self.whole, self.last = [], {}, {}

    def window(self, stop):
        def job(j):
            s = j % self.sets
            y = self.plan.ntt(self.x[s])
            self.rows.append(y[self.idx_dev[s]])
            jobs.sync(self.device)
            if j in self.keep:
                self.whole[j] = y
            self.last[s] = (j, y)

        return jobs.closed_loop(job, stop)

    def finish(self):
        self.rows = [r.cpu().numpy() for r in self.rows]
        self.whole.update(self.last.values())
        del self.plan, self.last

    def check(self):
        return self.judge(lambda s: self.x[s], self.rows, self.whole)


def _plan():
    from blaze_tpu_torch.ntt import FusedNTT

    return FusedNTT


def control(job):
    """Every output element left lazy (y + p)."""
    p = job.p
    return faults.wrap(_plan(), "ntt", lambda y, _: faults.lazy(y, p))


def unchanged(job):
    """The transform returns its input unchanged."""
    return mock.patch.object(_plan(), "ntt", lambda self, x: x.clone())


def half(job):
    """The transform of the first half of the input, the rest zeroed."""
    orig = _plan().ntt

    def first_half(self, x):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return orig(self, x)

    return mock.patch.object(_plan(), "ntt", first_half)


def altered(job):
    """One output element, a third of the way in, changed by one."""
    def after(y, _):
        y[y.shape[0] // 3, 0] ^= 1
        return y

    return faults.wrap(_plan(), "ntt", after)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
