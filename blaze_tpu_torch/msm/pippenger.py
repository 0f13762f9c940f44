"""Pippenger multi-scalar multiplication on the GPU.

Replaces the reference's FPGA MSM engine (`blaze/src/ingo_msm/`,
register lifecycle in msm_api.rs:72-274) with the JAX package's fused
bucket method (blaze_tpu/msm/pippenger.py `_fused_chunk`), step for step:

  1. c-bit digits of the 16-bit scalar limbs (optionally balanced/signed);
  2. per window, a stable sort of the point indices by digit, and the
     bucket bounds e_j = #(digit <= j) - 1 from a histogram and a cumsum;
  3. the sorted points laid out as C rows of G*R lanes and scanned by the
     K2 kernel: every lane's inclusive EC prefix (~N adds per window);
  4. the lane totals' exclusive prefix by Kogge-Stone doubling on K3;
  5. by Abel summation sum_j j*B_j = (B-1)*T[e_{B-1}] - sum_{j<B-1} T[e_j]
     with T the prefix sum, gathered at the bounds: (B-1)*T on K5, the
     sum over the bounds on K4;
  6. the Horner window fold on K6, of one chunk's window sums or of the
     streamed chunks' sums, accumulated per window on K3.

Same defaults, digit order, lane counts, paddings and reduction disciplines
as the JAX package, so on one input both produce the same projective limbs.
CUDA tensors go through the kernels; CPU tensors through their plain
versions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..curves.kernels import ECKernels
from ..curves.ops import Curve
from ..fields.spec import LIMB_BITS
from .residency import points_to_resident, scalars_to_resident


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    """Planning knobs that change which windows, chunks and lanes run."""

    window_bits: int = 16          # c; buckets per window B = 2^c
    chunk_log2: int = 19           # points per device pass
    scan_lanes: int = 0            # 0 = auto (~sqrt of padded chunk)
    # Balanced (signed) digits: buckets halve to 2^(c-1)+1 at the cost of
    # a conditional Y negation per scanned point.
    signed_digits: bool = False


def default_window_bits(n: int) -> int:
    """Pick c so bucket work (~3*2^c) stays well below scan work (~n)."""
    if n <= 0:
        return 1
    return max(1, min(16, int(math.log2(max(n, 2))) - 3))


class MSM:
    """Pippenger MSM engine for one curve."""

    def __init__(self, curve: Curve, config: MSMConfig | None = None):
        self.curve = curve
        self.config = config or MSMConfig()
        self.kern = ECKernels.for_curve(curve.spec)

    # ------------------------------------------------------------ digits
    @staticmethod
    def _digits_lm(scalars: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
        """(Ls, N) lanes-major 16-bit limbs -> (nwin, N) c-bit digits."""
        s = scalars.to(torch.int64) & 0xFFFF
        padded = torch.nn.functional.pad(s, (0, 0, 0, 2))
        mask = (1 << c) - 1
        outs = []
        for w in range(nwin):
            limb, off = divmod(w * c, LIMB_BITS)
            d = padded[limb] >> off
            if off + c > LIMB_BITS:
                d = d | (padded[limb + 1] << (LIMB_BITS - off))
            outs.append(d & mask)
        return torch.stack(outs, dim=0)

    @staticmethod
    def _signed_recode(digits: torch.Tensor, c: int):
        """Balanced-digit recode of (G, N) c-bit digits: returns (mag, sign)
        with mag in [0, 2^(c-1)] and sum_w (-1)^sign_w mag_w 2^(c w) ==
        scalar.  Digits >= 2^(c-1) become 2^c - d with a +1 carry into the
        next window; the top window stays unsigned (the caller guarantees
        its digit + carry <= 2^(c-1) by requiring total bits <= c*G - 1)."""
        G = digits.shape[0]
        half, full = 1 << (c - 1), 1 << c
        mags, signs = [], []
        carry = torch.zeros_like(digits[0])
        for w in range(G):
            d = digits[w] + carry
            if w == G - 1:
                mags.append(d)
                signs.append(torch.zeros_like(d))
                break
            hi = (d >= half).to(d.dtype)
            mags.append(torch.where(hi > 0, full - d, d))
            signs.append(hi)
            carry = hi
        return torch.stack(mags), torch.stack(signs)

    # ---------------------------------------------------------- helpers
    def _canon(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce words (..., W) from the kernels' lazy < 2p range to < p."""
        return self.curve.fq._cond_sub_p(
            x, torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
        )

    def _ident_col(self, device) -> torch.Tensor:
        """(3W, 1) lanes-major identity column."""
        return self.curve.identity(device=device).reshape(-1, 1)

    def _lm_to_pm(self, x: torch.Tensor) -> torch.Tensor:
        """(3W, G) lanes-major -> (G, 3, W) points-major."""
        return x.t().reshape(-1, 3, self.curve.nwords)

    @staticmethod
    def _pm_to_lm(x: torch.Tensor) -> torch.Tensor:
        """(G, 3, W) points-major -> (3W, G) lanes-major (contiguous)."""
        return x.reshape(x.shape[0], -1).t().contiguous()

    def _fused_reduce_rows(self, pts: torch.Tensor) -> torch.Tensor:
        """EC sum over axis 1 of (G, M, 3W) lazy points -> (G, 3, W) < p.

        One big reduce_cols pass to R2 lane totals per window, then further
        reduce_cols rounds down to one point per window."""
        G, M, threeW = pts.shape
        R2 = _ceil_pow2(int(math.sqrt(max(M, 4))))
        C2 = -(-M // R2)
        pad = R2 * C2 - M
        if pad:
            ident = self._ident_col(pts.device).reshape(1, 1, threeW)
            pts = torch.cat([pts, ident.expand(G, pad, threeW)], dim=1)
        # (G, R2, C2, 3W) -> rows (C2, 3W, G*R2): lane g*R2 + r
        rows = pts.reshape(G, R2, C2, threeW).permute(2, 3, 0, 1)
        tot = self.kern.reduce_cols(rows.reshape(C2, threeW, G * R2).contiguous())
        R = R2
        while R > 1:
            R3 = _ceil_pow2(int(math.sqrt(R))) if R > 4 else 1
            C3 = R // R3
            # lanes g*R + (r3*C3 + c3) -> rows (C3, 3W, G*R3)
            rows = tot.reshape(threeW, G, R3, C3).permute(3, 0, 1, 2)
            tot = self.kern.reduce_cols(rows.reshape(C3, threeW, G * R3).contiguous())
            R = R3
        return self._canon(self._lm_to_pm(tot))

    def _ks_lane_prefix(self, tot: torch.Tensor, G: int, R: int) -> torch.Tensor:
        """Exclusive EC prefix over the R lanes of each window.

        tot: (3W, G*R) lane totals (< 2p), lane g*R + r.  Returns (G, R, 3W)
        exclusive prefixes (< 2p): Kogge-Stone doubling, log2(R) batched
        adds on K3."""
        threeW = tot.shape[0]
        ident = self._ident_col(tot.device).reshape(threeW, 1, 1)
        x = tot.reshape(threeW, G, R)
        d = 1
        while d < R:
            shifted = torch.cat([ident.expand(threeW, G, d), x[:, :, :-d]], dim=2)
            x = self.kern.add(x.reshape(threeW, G * R),
                              shifted.reshape(threeW, G * R)).reshape(threeW, G, R)
            d *= 2
        excl = torch.cat([ident.expand(threeW, G, 1), x[:, :, :-1]], dim=2)
        return excl.permute(1, 2, 0)

    # ------------------------------------------------- one chunk, fused
    def _fused_chunk(self, pts: torch.Tensor, scalars: torch.Tensor, c: int,
                     scalar_bits: int | None = None) -> torch.Tensor:
        """Per-window sums (nwin, 3, W), canonical, of one chunk.

        pts: (2W, N) resident Montgomery points; scalars: (Ls, N) limbs."""
        cv, kern = self.curve, self.kern
        W = cv.nwords
        dev = pts.device
        N = pts.shape[1]
        bits = scalar_bits or cv.spec.fr.bits
        nwin = -(-bits // c)
        digits = self._digits_lm(scalars, c, nwin)
        G = nwin

        # balanced digits: sound only when the top window keeps a spare
        # bit for the incoming carry (total bits <= c*G - 1)
        signed = self.config.signed_digits and c >= 2 and bits <= c * nwin - 1
        if signed:
            mag, sgn = self._signed_recode(digits, c)
            digits = mag
            sortkey = (mag << 1) | sgn     # sign rides the sort key
            B = (1 << (c - 1)) + 1         # the bounds depend only on mag
        else:
            sortkey = digits
            B = 1 << c

        # stable, as jnp.argsort: equal digits keep point order, so every
        # lane sums the same points in the same order as the JAX package
        order = torch.argsort(sortkey, dim=-1, stable=True)       # (G, N)

        # bucket bounds e_j = #(digit <= j) - 1: a per-window histogram
        # (scatter_add, no host sync), then a cumsum
        nb = 1 << c
        hist = torch.zeros((G, nb), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, digits, torch.ones_like(digits))
        bounds = torch.cumsum(hist[:, :B], dim=-1) - 1             # (G, B)

        R = min(self.config.scan_lanes or _ceil_pow2(int(math.sqrt(N))), N)
        C = -(-N // R)
        pad = R * C - N
        sp = pts[:, order]                                         # (2W, G, N)
        if signed:
            sgn_sorted = torch.gather(sortkey, 1, order) & 1
            sp = torch.cat([sp, sgn_sorted.to(torch.int32)[None]], dim=0)
        nr = sp.shape[0]
        if pad:
            # repeat the last sorted point; pads sort past every bucket so
            # no bound ever reaches them
            sp = torch.cat([sp, sp[:, :, -1:].expand(nr, G, pad)], dim=2)
        # (nr, G, R, C) -> rows (C, nr, G*R); point n = r*C + c of window g
        rows = sp.reshape(nr, G, R, C).permute(3, 0, 1, 2).reshape(C, nr, G * R)
        emitted, tot = kern.scan_mixed(rows.contiguous())  # (C, 3W, GR), (3W, GR)

        excl = self._ks_lane_prefix(tot, G, R)             # (G, R, 3W)

        safe = bounds.clamp(min=0)
        lane_idx = safe // C
        col_idx = safe % C
        gidx = torch.arange(G, device=dev)[:, None]
        local = emitted[col_idx, :, gidx * R + lane_idx]   # (G, B, 3W)
        carry = excl[gidx, lane_idx]                       # (G, B, 3W)
        valid = (bounds >= 0)[..., None]
        ident = self._ident_col(dev).reshape(1, 1, 3 * W)
        local = torch.where(valid, local, ident)
        carry = torch.where(valid, carry, ident)

        # ---- bucket phase (Abel summation).  Only the two B-1 columns
        # enter Field-level group ops -> canonicalize them.
        total = cv.add(self._canon(carry[:, B - 1].reshape(G, 3, W)),
                       self._canon(local[:, B - 1].reshape(G, 3, W)))   # (G, 3, W)
        # (B-1) * T: unsigned B-1 = 2^c - 1 doubles c times and subtracts
        # T; signed B-1 = 2^(c-1) is a pure doubling chain
        tot_lm = self._pm_to_lm(total)
        if signed:
            acc = self._canon(self._lm_to_pm(kern.dbl_n(tot_lm, c - 1)))
        else:
            shifted = self._canon(self._lm_to_pm(kern.dbl_n(tot_lm, c)))
            acc = cv.add(shifted, cv.neg(total))
        if B > 1:
            rest = torch.cat([carry[:, : B - 1], local[:, : B - 1]], dim=1)
            acc = cv.add(acc, cv.neg(self._fused_reduce_rows(rest)))
        return acc

    # ------------------------------------------------------------- driver
    def _as_resident(self, points, scalars):
        """Points-major (N, 2, W) / (N, Ls) operands -> resident layouts;
        the scalar layout follows the point layout."""
        if points.dim() == 3:
            return (points_to_resident(self.curve, points, mont=True),
                    scalars_to_resident(scalars))
        return points, scalars

    def msm_partial(self, points, scalars, c: int, scalar_bits: int | None = None):
        """Per-window sums (nwin, 3, W) of one resident chunk."""
        points, scalars = self._as_resident(points, scalars)
        return self._fused_chunk(points, scalars, c, scalar_bits)

    def accumulate(self, wsums, part):
        """Running per-window accumulation across streamed chunks: one K3
        launch over the windows' sums, canonicalized."""
        if wsums is None:
            return part
        out = self.kern.add(self._pm_to_lm(wsums), self._pm_to_lm(part))
        return self._canon(self._lm_to_pm(out))

    def fold_windows(self, wsums, c: int):
        """Horner fold sum_w 2^(c*w) * wsums[w] on the Field (alg 9
        doublings): the Field-level reference that `finalize` (K6) is held
        to in the tests."""
        cv = self.curve
        acc = wsums[-1]
        for w in range(wsums.shape[0] - 2, -1, -1):
            for _ in range(c):
                acc = cv.dbl(acc)
            acc = cv.add(acc, wsums[w])
        return acc

    def finalize(self, wsums, c: int):
        """Horner window fold of the (nwin, 3, W) window sums -> (3, W) mont,
        canonical: one K6 launch (lazy), canonicalized."""
        if wsums.shape[0] == 1:
            return wsums[0]
        res = self.kern.fold_horner(self._pm_to_lm(wsums), c)
        return self._canon(res.reshape(3, self.curve.nwords))

    def __call__(self, points, scalars, window_bits: int | None = None,
                 scalar_bits: int | None = None):
        """MSM of Montgomery affine points — (N, 2, W) points-major or (2W, N)
        resident — with canonical scalar limbs, (N, Ls) or (Ls, N).  Returns
        one projective point (3, W), Montgomery form.

        Inputs up to 2^chunk_log2 points run as one chunk; larger ones stream
        in chunks whose window sums are accumulated (K3) and folded once on
        K6 (the reference's DMA chunking analog, msm_api.rs:156)."""
        points, scalars = self._as_resident(points, scalars)
        n = points.shape[1]
        c = window_bits or min(self.config.window_bits, default_window_bits(n))
        chunk = 1 << self.config.chunk_log2
        if n <= chunk:
            return self.finalize(self._fused_chunk(points, scalars, c, scalar_bits), c)
        wsums = None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            part = self._fused_chunk(points[:, lo:hi], scalars[:, lo:hi], c,
                                     scalar_bits)
            wsums = self.accumulate(wsums, part)
        return self.finalize(wsums, c)

    def msm_precomputed(self, expanded_points, scalars, factor: int,
                        window_bits: int | None = None):
        """MSM with precomputed multiples (the reference's 8x mode).

        `expanded_points`: (factor*N, 2, W) from msm.precompute_points
        (multiple-major); `scalars`: (N, Ls) canonical limbs."""
        from .precompute import split_scalars

        sliced, bits = split_scalars(scalars, factor, self.curve.spec.fr.bits)
        return self(expanded_points, sliced, window_bits=window_bits,
                    scalar_bits=bits)
