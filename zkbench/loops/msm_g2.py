"""MSM.__call__ on resident BN254 G2 bases in a closed loop: a Groth16
prover's [B]_2.  msm_resident's loop (its window), with the bases k_u P2 of
the plain reference zkbench/reference/bn254_g2.py, the engine on
CURVES["bn254_g2"] (F_p2 coordinates: (4W, N) resident rows, a (3, 2W)
projective result), and the judgement of each result as an affine F_p2
point against the reference's MSM of the class sums, limit 0."""
from __future__ import annotations

import types

import numpy as np
import torch

from zkbench import faults, jobs, work
from zkbench.loops import msm_resident
from zkbench.reference import bn254_g2 as g2
from zkbench.reference.fields import ints_to_words, nwords, words_to_ints

# F_p words of one F_p2 component
W = nwords(g2.P)
# warm MSMs of set-up, the sets in turn
WARMUPS = 2


def _require_g2():
    """A program without BN254's G2 fails here, as the harness loads this
    loop: in seconds, before it builds the program's kernels."""
    from blaze_tpu_torch.curves import CURVES

    return CURVES["bn254_g2"]


_require_g2()


class Loop(msm_resident.Loop):
    libs = ("montmul", "field_ew", "ec_kernels_g2")

    def __init__(self, cfg, traffic, seed, device):
        jobs.Job.__init__(self, cfg, traffic, seed, device)
        self.curve = cfg["curve"]
        self.n = 1 << int(cfg["msm_log_points"])
        self.U = int(cfg["msm_unique_points"])
        self.c = int(cfg["msm_window_bits"])
        # the moduli MSMJob's scalars and the control read
        self.g1 = types.SimpleNamespace(p=g2.P, r=g2.R)
        self.units_per_job = self.n

    # ------------------------------------------------------ the work counts
    def _windows(self) -> int:
        return -(-g2.R.bit_length() // self.c)

    @staticmethod
    def _imads(products: int) -> int:
        """F_p2 products by Karatsuba with lazy reduction: three unreduced
        W-word products (2W^2 IMADs each) and two REDCs (2W^2 + W each)."""
        return products * (3 * 2 * W * W + 2 * (2 * W * W + W))

    def work(self):
        """The whole MSM's least work: msm_work's products, each an F_p2
        product, the resident bases (128 B) and scalars read once."""
        Ls = 2 * nwords(g2.R)
        nbytes = work.msm_work(self.n, self.c, 2 * W, g2.R.bit_length(), Ls)[0]
        imads = work.msm_work(self.n, self.c, W, g2.R.bit_length(), Ls)[1]
        return nbytes, self._imads(imads // work.product_imads(W))

    def scan_work(self):
        """K2's least work: every base added into its bucket in every window,
        one mixed add (13 products), the bases read once."""
        return self.n * 4 * W * 4, self._imads(13 * self._windows() * self.n)

    def bucket_work(self):
        """The bucket reduction's least work: per window the running sums'
        2 (2^c - 1) complete adds (14 products), each bucket read once."""
        nwin, nb = self._windows(), 1 << self.c
        return nwin * nb * 6 * W * 4, self._imads(14 * 2 * (nb - 1) * nwin)

    # ---------------------------------------------------------- the loop
    def make_points(self) -> list:
        self.points = g2.subgroup_points(self.U, jobs.sub_seed(self.seed, "points"))
        return self.points

    def setup(self):
        spec = _require_g2()          # first, before anything is allocated
        from blaze_tpu_torch.curves import Curve
        from blaze_tpu_torch.msm import MSM, points_to_resident

        cv = Curve(spec)
        words = ints_to_words([c for pt in self.make_points() for xy in pt for c in xy], W)
        pts = torch.from_numpy(words.view(np.int32).reshape(self.U, 2, 2 * W)).to(self.device)
        self.resident = points_to_resident(cv, pts).repeat(1, self.n // self.U)
        self.make_scalars()
        self.msm = MSM(cv)
        for s in range(WARMUPS):
            self.msm(self.resident, self.scalars[s % self.sets])
        jobs.sync(self.device)
        self.outs = []

    def finish(self):
        """Each result as ((X0, X1), (Y0, Y1), (Z0, Z1)) of ints."""
        res = [words_to_ints(o.reshape(6, W).cpu().numpy()) for o in self.outs]
        self.results = [tuple(tuple(r[2 * i:2 * i + 2]) for i in range(3)) for r in res]
        del self.outs, self.msm, self.resident

    def check(self):
        U, n, r, p = self.U, self.n, g2.R, g2.P
        want = []
        for sc in self.scalars:
            cols = sc.reshape(sc.shape[0], n // U, U).to(torch.int64).sum(dim=1).cpu()
            sums = [sum(int(v) << (16 * l) for l, v in enumerate(cols[:, u].tolist())) % r
                    for u in range(U)]
            want.append(g2.tiled_msm(self.points, sums))
        bad = []
        for j, (X, Y, Z) in enumerate(self.results):
            ok = max(*X, *Y, *Z) < p and Z != g2.ZERO
            if ok:
                zi = g2.inv(Z)
                ok = (g2.mul(X, zi), g2.mul(Y, zi)) == want[j % self.sets]
            if not ok:
                bad.append(j)
        return {"msm_results_wrong": (len(bad), 0)}, bad


def control(job):
    """The MSM's projective result with X's first component left lazy (+p)."""
    p = job.g1.p

    def after(out, _):
        out = out.clone()
        out[0, :W] = faults.lazy(out[0, :W], p)
        return out

    return faults.wrap(msm_resident._msm(), "__call__", after)


FAULTS = {"unchanged": msm_resident.stale, "half": msm_resident.half,
          "altered": msm_resident.altered}
