"""PoseidonClient.start_process -> wait_result -> root in a closed loop
over TreeC columns staged on the device in set-up, one client (column
set) per job in turn.  After the window each client's last tree is
drained as records (result_raw) for the judgement."""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np

from zkbench import faults, jobs
from zkbench.reference.fields import nwords


class Loop(jobs.TreeJob):
    libs = ("montmul", "field_ew", "poseidon_kernels")

    def setup(self):
        from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

        self.host_cols, self.clients = [], []
        for s in range(self.sets):
            cols = self.make_columns(s)
            host = cols.cpu().numpy().view(np.uint32)
            del cols
            cl = PoseidonClient(self.field, device=str(self.device))
            cl.initialize(PoseidonInitializeParameters(tree_height=self.height))
            cl.set_data(memoryview(host).cast("B"))
            cl.start_process()                  # stages the columns on the device
            cl.wait_result()
            _ = cl.root                         # the job reads it too
            self.host_cols.append(host)
            self.clients.append(cl)
        jobs.sync(self.device)
        self.roots = []

    def window(self, stop):
        def job(j):
            cl = self.clients[j % self.sets]
            cl.start_process()
            cl.wait_result()
            self.roots.append(cl.root.copy())

        return jobs.closed_loop(job, stop)

    def finish(self):
        self.raw = [cl.result_raw() for cl in self.clients]
        del self.clients


def _client():
    from blaze_tpu_torch.runtime import PoseidonClient

    return PoseidonClient


def _permutation():
    from blaze_tpu_torch.hash import PoseidonKernels

    return PoseidonKernels


def _records_lazy(raw: bytes, p: int, W: int) -> bytes:
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 64).copy()
    words = np.ascontiguousarray(rec[:, :4 * W]).view("<u4")
    rec[:, :4 * W] = faults.lazy_words(words, p).view(np.uint8)
    return rec.tobytes()


def control(job):
    """Every record's hash and every root left lazy (h + p)."""
    p, W = job.p, nwords(job.p)
    cls = _client()
    root = cls.root
    stack = contextlib.ExitStack()
    stack.enter_context(faults.wrap(cls, "result_raw",
                                    lambda raw, _: _records_lazy(raw, p, W)))
    stack.enter_context(mock.patch.object(
        cls, "root", property(lambda self: faults.lazy_words(root.fget(self)[None], p)[0])))
    return stack


def unchanged(job):
    """The permutation returns its state unchanged."""
    def same(self, state, *a, out=None, **k):
        if out is not None and out is not state:
            out.copy_(state)
            return out
        return state

    return mock.patch.object(_permutation(), "permute_lm", same)


def half(job):
    """Only the first half of the leaves hashed; the rest left as their
    first column element."""
    orig = _permutation().permute_lm

    def first_half(self, state, *a, out=None, **k):
        if state.shape[0] != job.columns + 1:
            return orig(self, state, *a, out=out, **k)
        n = state.shape[-1] // 2
        res = orig(self, state[..., :n].contiguous(), *a, **k)
        target = state if out is None else out
        target[..., :n] = res
        return target

    return mock.patch.object(_permutation(), "permute_lm", first_half)


def altered(job):
    """One leaf hash changed by one where the leaf permutation produces it
    (its parents are hashed from the altered value)."""
    orig = _permutation().permute_lm

    def one_leaf(self, state, *a, out=None, **k):
        res = orig(self, state, *a, out=out, **k)
        if state.shape[0] == job.columns + 1:
            res[1, 0, res.shape[-1] // 3] ^= 1
        return res

    return mock.patch.object(_permutation(), "permute_lm", one_leaf)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
