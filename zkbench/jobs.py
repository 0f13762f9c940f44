"""What the job loops share: inputs made from the seed, the closed loop, and
the judgement of each kind of output against the plain reference.

A traffic mix is a data file (`traffic/<mix>.json`) whose `job` names a
job loop, `loops/<job>.py`, found by name, and whose other keys set it
(input sets, jobs traced, the sampling of the comparison); the
configuration file gives the sizes.  A loop file defines

  Loop            a subclass of one of the jobs below, which drives the
                  program's public entry points
  control(job)    a context manager that puts the control in the
                  program's place under the timed path (faults.py)
  FAULTS          {"unchanged" | "half" | "altered": the same, for each
                  planted fault the loop can have}

and a Loop has this surface:

  libs            the program's native libraries it runs (built in set-up)
  unit            what its end-to-end rate counts ("points", ...)
  units_per_job   that count for one job
  work()          (bytes, IMADs) of one job, from zkbench/work.py
  setup()         inputs, program objects, one warm job per input set
  window(stop)    runs jobs until stop(jobs done, seconds elapsed) is
                  true (never before one job of each input set); returns
                  one record per job (dict with "submit" and "done",
                  seconds from the window's start)
  finish()        collects the outputs and frees the program's state
  check()         {number compared: (value, limit)}, and the jobs found
                  wrong

A new kind of job is a new loop file, which may reuse the jobs here.
"""
from __future__ import annotations

import hashlib
import random
import time

import numpy as np
import torch

from . import work
from .reference import ec, evaluate, poseidon
from .reference.fields import (
    count_noncanonical,
    modulus,
    nwords,
    root_of_unity,
    words_to_ints,
)


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and `tags`."""
    h = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def random_field_words(p: int, shape: tuple, seed: int, device) -> torch.Tensor:
    """(*shape, W) int32 words of canonical elements of F_p, made on
    `device` from `seed`: uniform low words, the top word uniform below
    p's top word (so every element is below p)."""
    W = nwords(p)
    g = generator(seed, device)
    low = torch.randint(-(1 << 31), 1 << 31, (*shape, W - 1), dtype=torch.int32,
                        device=device, generator=g)
    top = torch.randint(0, p >> (32 * (W - 1)), (*shape, 1), dtype=torch.int64,
                        device=device, generator=g).to(torch.int32)
    return torch.cat([low, top], dim=-1)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def job_span():
    """The host span of one job, which the traced run's readers find."""
    from torch.profiler import record_function

    return record_function("zkbench.job")


def closed_loop(job, stop) -> list:
    """job(j) until stop(j, elapsed); each job returns once its result is
    ready.  One record per job: submit and done, seconds from the start."""
    recs, j, t0 = [], 0, time.perf_counter()
    while not stop(j, time.perf_counter() - t0):
        ts = time.perf_counter() - t0
        with job_span():
            extra = job(j)
        recs.append({"submit": ts, "done": time.perf_counter() - t0, **(extra or {})})
        j += 1
    return recs


class Job:
    libs: tuple = ()
    unit = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.sets = int(traffic["input_sets"])
        if self.sets < 2:
            raise ValueError("a mix needs at least two input sets, so that no job "
                             "can be answered with the last job's result")


# ====================================================================== MSM
class MSMJob(Job):
    """An MSM of 2^msm_log_points terms: `msm_unique_points` order-r points
    tiled (the upstream test's instance), scalars uniform below r made on
    the device, one set per job in turn.  A loop sets self.results to one
    projective (X, Y, Z) of ints per job; every one is judged."""

    unit = "points"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.curve = cfg["curve"]
        self.n = 1 << int(cfg["msm_log_points"])
        self.U = int(cfg["msm_unique_points"])
        self.g1 = ec.G1(self.curve)
        self.units_per_job = self.n

    def work(self):
        p, r = self.g1.p, self.g1.r
        return work.msm_work(self.n, int(self.cfg["msm_window_bits"]), nwords(p),
                             r.bit_length(), 2 * nwords(r))

    def make_points(self) -> list:
        self.points = ec.subgroup_points(self.curve, self.U, sub_seed(self.seed, "points"))
        return self.points

    def make_scalars(self) -> list:
        """self.sets (2 nwords(r), n) int32 tensors of 16-bit limbs on the
        device, each scalar below r."""
        Ls, r = 2 * nwords(self.g1.r), self.g1.r
        self.scalars = []
        for s in range(self.sets):
            g = generator(sub_seed(self.seed, "scalars", s), self.device)
            low = torch.randint(0, 1 << 16, (Ls - 1, self.n), dtype=torch.int32,
                                device=self.device, generator=g)
            top = torch.randint(0, r >> (16 * (Ls - 1)), (1, self.n), dtype=torch.int32,
                                device=self.device, generator=g)
            self.scalars.append(torch.cat([low, top]))
        return self.scalars

    def check(self):
        U, n, r, p = self.U, self.n, self.g1.r, self.g1.p
        want = []
        for sc in self.scalars:
            cols = sc.reshape(sc.shape[0], n // U, U).to(torch.int64).sum(dim=1).cpu()
            sums = [sum(int(v) << (16 * l) for l, v in enumerate(cols[:, u].tolist())) % r
                    for u in range(U)]
            want.append(ec.tiled_msm(self.curve, self.points, sums))
        bad = []
        for j, (X, Y, Z) in enumerate(self.results):
            ok = max(X, Y, Z) < p and Z % p != 0
            if ok:
                zi = pow(Z, -1, p)
                ok = (X * zi % p, Y * zi % p) == want[j % self.sets]
            if not ok:
                bad.append(j)
        return {"msm_results_wrong": (len(bad), 0)}, bad


# ===================================================================== tree
class TreeJob(Job):
    """A TreeC build over `leaf_columns`-element columns, `tree_arity`-ary,
    `tree_height` layers, one column set per job in turn.  A loop sets
    self.host_cols (per set, the columns as uint32 words), self.raw (per
    set, the records of its last build: 64 bytes each, the hash's words,
    then layer << 30 | index) and self.roots (per job, the root's words).

    The judgement, per set: the records' count and ids; `sampled_leaves`
    leaves drawn from the seed and a whole subtree of `subtree_height`
    layers drawn from the seed against the Poseidon hash of their
    columns; `sampled_nodes` nodes per layer (all of a smaller layer), the
    subtree's nodes and its path to the root against the hash of their
    children; every build's root against the drained root."""

    unit = "leaves"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.field = cfg["field"]
        self.p = modulus(self.field)
        self.height = int(cfg["tree_height"])
        self.arity = int(cfg["tree_arity"])
        self.columns = int(cfg["leaf_columns"])
        self.nleaves = self.arity ** (self.height - 1)
        self.units_per_job = self.nleaves

    def work(self):
        leaf, node = self.instance("leaf"), self.instance("node")
        return work.tree_work(self.height, self.arity, self.columns, nwords(self.p),
                              leaf, node)

    def instance(self, which: str) -> dict:
        c = self.cfg["poseidon"][which]
        return {"t": int(c["t"]), "r_f": int(c["full_rounds"]),
                "r_p": int(c["partial_rounds"]), "alpha": int(c["alpha"])}

    def make_columns(self, s: int) -> torch.Tensor:
        """Set s's columns, (nleaves * leaf_columns, W) int32 words on the
        device."""
        return random_field_words(self.p, (self.nleaves * self.columns,),
                                  sub_seed(self.seed, "columns", s), self.device)

    def _picks(self, rng: random.Random) -> tuple:
        """{layer: node indices to check} and the leaves to check."""
        a, h = self.arity, self.height
        sizes = [a ** (h - 1 - l) for l in range(h)]
        sub = min(int(self.traffic["subtree_height"]), h - 1)
        top = rng.randrange(sizes[sub])              # the subtree's root, in layer sub
        n_nodes = int(self.traffic["sampled_nodes"])
        picks = {}
        for l in range(h):
            if sizes[l] <= n_nodes:
                got = set(range(sizes[l]))
            else:
                got = set(rng.sample(range(sizes[l]), n_nodes))
            if l <= sub:
                span = a ** (sub - l)
                got.update(range(top * span, (top + 1) * span))
            else:
                got.add(top // a ** (l - sub))
            picks[l] = sorted(got)
        leaves = set(rng.sample(range(self.nleaves),
                                min(self.nleaves, int(self.traffic["sampled_leaves"]))))
        return picks, sorted(leaves | set(picks[0]))

    def check(self):
        W, a, h = nwords(self.p), self.arity, self.height
        leaf = poseidon.instance(self.p, **self.instance("leaf"))
        node = poseidon.instance(self.p, **self.instance("node"))
        sizes = [a ** (h - 1 - l) for l in range(h)]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        want_l = np.repeat(np.arange(h, dtype=np.uint64), sizes)
        want_h = np.concatenate([np.arange(s, dtype=np.uint64) for s in sizes])
        wrong, bad = 0, set()
        for s, raw in enumerate(self.raw):
            jobs = list(range(s, len(self.roots), self.sets))
            rec = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 64)
            if len(rec) != len(want_l):
                wrong += 1
                bad.update(jobs[-1:])
                continue
            meta = np.ascontiguousarray(rec[:, 32:40]).view("<u8")[:, 0]
            errs = int(np.count_nonzero(meta >> np.uint64(30) != want_l))
            errs += int(np.count_nonzero(meta & np.uint64(0x3FFFFFFF) != want_h))
            words = rec[:, :4 * W]

            def hashes(i, k=1):                 # records i .. i+k-1 as ints
                return words_to_ints(np.ascontiguousarray(words[i:i + k]).view("<u4"))

            picks, leaves = self._picks(random.Random(sub_seed(self.seed, "tree_check", s)))
            cols = self.host_cols[s].reshape(self.nleaves, self.columns, W)
            for i in leaves:
                errs += [poseidon.hash_(leaf, words_to_ints(cols[i]))] != hashes(i)
            for l in range(1, h):
                for j in picks[l]:
                    kids = hashes(starts[l - 1] + a * j, a)
                    errs += [poseidon.hash_(node, kids)] != hashes(starts[l] + j)
            if errs:
                bad.update(jobs[-1:])
            root = hashes(len(rec) - 1)
            stale = [j for j in jobs if words_to_ints(self.roots[j][None]) != root]
            bad.update(stale)
            wrong += errs + len(stale)
        return {"tree_hashes_wrong": (wrong, 0)}, sorted(bad)


# ====================================================================== NTT
class NTTJob(Job):
    """A forward NTT of 2^ntt_log_size elements of `ntt_field`, one input
    set per job in turn.  Each job's output is read at `sampled_points`
    indices drawn from the seed per input set and held to the reference's
    evaluation of that input there.  Whole outputs are kept of one job per
    set drawn from the seed among the first `whole_checks_among_first`
    rounds (self.keep) and of each set's last job: each must be canonical
    and must evaluate at w^(-i) to n x_i at `inverse_points` indices i
    drawn from the seed, which a wrong element anywhere in it shifts."""

    unit = "elements"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.field = cfg["ntt_field"]
        self.p = modulus(self.field)
        self.logn = int(cfg["ntt_log_size"])
        self.n = 1 << self.logn
        self.W = nwords(self.p)
        self.units_per_job = self.n
        rng = random.Random(sub_seed(seed, "ntt_points"))
        k = int(traffic["sampled_points"])
        self.idx = [sorted({0, self.n - 1, *(rng.randrange(self.n) for _ in range(k - 2))})
                    for _ in range(self.sets)]
        first = int(traffic["whole_checks_among_first"])
        self.keep = {rng.randrange(first) * self.sets + s for s in range(self.sets)}
        self.inverse_points = int(traffic["inverse_points"])

    def work(self):
        return work.ntt_work(self.logn, self.W)

    def make_input(self, s: int) -> torch.Tensor:
        return random_field_words(self.p, (self.n,), sub_seed(self.seed, "ntt_input", s),
                                  self.device)

    def judge(self, inputs, rows: list, whole: dict):
        """inputs(s) -> the (n, W) input of set s on the device; rows[j]:
        job j's output words at self.idx[j % sets]; whole: {job: (n, W)
        output on the device}."""
        p, n = self.p, self.n
        w = root_of_unity(p, self.logn)
        wrong, bad = 0, set()
        rng = random.Random(sub_seed(self.seed, "ntt_inverse"))
        for s in range(self.sets):
            x = inputs(s)
            want = evaluate.evaluate(x, [pow(w, k, p) for k in self.idx[s]], p)
            for j in range(s, len(rows), self.sets):
                errs = sum(g != v for g, v in zip(words_to_ints(rows[j]), want))
                wrong += errs
                if errs:
                    bad.add(j)
            for j in sorted(k for k in whole if k % self.sets == s):
                y = whole[j]
                errs = count_noncanonical(y, p)
                ii = [rng.randrange(n) for _ in range(self.inverse_points)]
                got = evaluate.evaluate(y, [pow(w, -i, p) for i in ii], p)
                xi = words_to_ints(x[torch.tensor(ii, device=x.device)].cpu().numpy())
                errs += sum(g != n * v % p for g, v in zip(got, xi))
                wrong += errs
                if errs:
                    bad.add(j)
            del x
        return {"ntt_values_wrong": (wrong, 0)}, sorted(bad)
