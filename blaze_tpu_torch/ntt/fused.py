"""Composed NTT: Cooley-Tukey recursion over the base kernels (K7-K9).

Port of blaze_tpu/ntt/fused.py FusedNTT.  A size-2^logn transform is split
into balanced factors of at most 2^KLOG points (`split_parts`); each factor
is one K7 launch over all its sub-transforms, and between factors sit an
inter-level twiddle (K9, or K8 for narrow cells) and torch transposes — the
analog of the reference's 16-bank HBM shuffle
(`blaze/src/ingo_ntt/ntt_data.rs:80-156`).

The inter-level twiddle W^(j*v) of a K = A*C split is applied from two
SPLIT TABLES: with j = jo*S + jl (S ~ sqrt(C)),

    W^(j*v) = T1[v, jo] * T2[v, jl],   T1 from W^(S*m), T2 from W^m,

each table A*C/S or A*S entries (8 MiB at 2^27), never the K-entry matrix.
n^-1 of the inverse is folded into the depth-0 inverse T1.

Working layout: (K, W, B) int32 words — transform index on the leading
axis, the element's 8 words next, B independent transforms on the lanes.
A points-major (n, W) input is the B = 1 case.  All values are canonical
Montgomery representatives.

Left out from the JAX plan: the lane-expanded packs and u16 storage (Mosaic
and TPU-tiling workarounds), the u16 donated entry points and the blocked
layout (the TPU pads a (K, 16) u16 array 8x; (n, 8) int32 words already
take exactly 32 B per element).
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import Field
from ..fields.spec import FieldSpec, int_to_words
from .kernels import MAX_LOGK, NTTKernels, lane_cols

__all__ = ["FusedNTT", "split_parts", "tables_from_reference"]

KLOG = MAX_LOGK   # max log2 base-kernel size (K7's shared-memory tile)


def split_parts(logn: int, klog: int = KLOG) -> list[int]:
    """Balanced decomposition of logn into parts each <= klog."""
    if logn <= klog:
        return [max(logn, 0)]
    nparts = -(-logn // klog)
    base, rem = divmod(logn, nparts)
    return [base + 1] * rem + [base] * (nparts - rem)


def _u16_to_words(a: np.ndarray) -> torch.Tensor:
    """(R, L, X) 16-bit limbs (any integer dtype) -> (R, L/2, X) int32 words."""
    limbs = np.moveaxis(np.asarray(a).astype("<u2"), 1, -1).copy()
    words = limbs.view("<u4")                             # (R, X, W)
    return torch.from_numpy(np.moveaxis(words, -1, 1).copy().view(np.int32))


def tables_from_reference(packs: dict, tabs: dict) -> tuple[dict, dict]:
    """The JAX plan's tables in the port's layout.

    packs: {(a, inverse): (A, L, T) u16} lane-expanded base-kernel twiddle
    packs (blaze_tpu FusedNTT._packs); tabs: {(depth, inverse): ((A, L, J),
    (A, L, S)) u16} split inter-level tables (FusedNTT._tabs), as numpy
    arrays.  Returns ({key: (A, W) int32}, {key: ((A, W, J), (A, W, S))
    int32}) — FusedNTT._packs / _tabs of the port on the CPU."""
    out_packs = {k: _u16_to_words(np.asarray(v)[:, :, :1])[:, :, 0].contiguous()
                 for k, v in packs.items()}
    out_tabs = {k: (_u16_to_words(t1), _u16_to_words(t2)) for k, (t1, t2) in tabs.items()}
    return out_packs, out_tabs


class FusedNTT:
    """NTT plan for one (field, logn), its tables on `device`.  `.ntt` /
    `.intt` map (n, W) int32 canonical Montgomery words, natural order in
    and out, to a new (n, W) tensor; the input is left as it was."""

    # Cells narrower than this many lanes take the K8 fallback with
    # lane-expanded twiddles (only small plans, 2^10-2^19); tests may lower
    # it to force K9 at small sizes.
    _TWMUL_MIN_LANES = 128

    def __init__(self, spec: FieldSpec, logn: int, klog: int = KLOG, device="cuda"):
        if logn > spec.two_adicity:
            raise ValueError(
                f"{spec.name}: 2-adicity {spec.two_adicity} < logn {logn}"
            )
        if not 1 <= klog <= MAX_LOGK:
            raise ValueError(f"klog {klog} outside [1, {MAX_LOGK}]")
        self.spec = spec
        self.field = Field(spec)
        self.logn = logn
        self.n = 1 << logn
        self.parts = split_parts(logn, klog)
        self.device = torch.device(device)
        self.kern = NTTKernels.for_spec(spec)

        p, W = spec.p, spec.nwords
        f = self.field
        dev = self.device

        def mont(v: int) -> torch.Tensor:
            return torch.as_tensor(int_to_words((v * spec.r) % p, W).view(np.int32),
                                   device=dev)

        self._ninv_mont = mont(pow(self.n, -1, p))

        # ---- base-kernel twiddle packs, one per distinct part size.
        # pack[m-1+t] (m = 2^s) = W_A^(t << (a-1-s)): the stage-s slice is
        # the contiguous rows [m-1, 2m-1).
        self._packs = {}
        for a in sorted(set(self.parts)):
            if a == 0:
                continue
            A = 1 << a
            idx = np.zeros(A, dtype=np.int64)
            for s in range(a):
                m = 1 << s
                idx[m - 1 : 2 * m - 1] = np.arange(m) << (a - 1 - s)
            half = max(A // 2, 1)
            for inv in (False, True):
                wa = spec.root_of_unity(a)
                if inv:
                    wa = pow(wa, -1, p)
                pows = f.powers(mont(wa), half)                    # (A/2, W)
                self._packs[(a, inv)] = pows[torch.as_tensor(idx % half, device=dev)]

        # ---- inter-level split twiddle tables, one pair per node depth.
        # Depth d splits K_d = prod(parts[d:]) as A_d * C_d; entry (v, j =
        # jo*S + jl) of the depth's (A, C) grid takes W^(j*v) =
        # tab1[v, :, jo] * tab2[v, :, jl].
        self._tabs = {}
        for d in range(len(self.parts) - 1):
            logK = sum(self.parts[d:])
            a = self.parts[d]
            logC = logK - a
            logS = (logC + 1) // 2
            A, S = 1 << a, 1 << logS
            J = (1 << logC) >> logS
            n1 = (J - 1) * (A - 1) + 1
            n2 = (S - 1) * (A - 1) + 1
            vgrid = torch.arange(A, device=dev)[:, None]
            idx1 = vgrid * torch.arange(J, device=dev)[None]
            idx2 = vgrid * torch.arange(S, device=dev)[None]
            for inv in (False, True):
                w = spec.root_of_unity(logK)
                if inv:
                    w = pow(w, -1, p)
                t1 = f.powers(mont(pow(w, S, p)), n1)             # (n1, W)
                t2 = f.powers(mont(w), n2)
                if inv and d == 0:
                    t1 = f.mul(t1, self._ninv_mont)
                self._tabs[(d, inv)] = (
                    t1[idx1].transpose(1, 2).contiguous(),         # (A, W, J)
                    t2[idx2].transpose(1, 2).contiguous(),         # (A, W, S)
                )

    # ------------------------------------------------------------ twiddle
    def _apply_twiddle(self, y: torch.Tensor, depth: int, B: int,
                       inverse: bool) -> torch.Tensor:
        """y: (A, W, C*B), lane = j*B + b.  Multiply entry (v, j) by
        W^(j*v) = tab1[v, j//S] * tab2[v, j%S] — in place on K9 (y is the
        plan's own buffer here)."""
        tab1, tab2 = self._tabs[(depth, inverse)]
        J, S = tab1.shape[2], tab2.shape[2]
        cell = S if B == 1 else B
        if cell >= self._TWMUL_MIN_LANES:
            return self.kern.twiddle_mul(y, tab1, tab2, B, out=y)
        # small-plan fallback: expand the twiddles lane-wise and use the
        # generic triple-product kernel
        jo, jl = lane_cols(J, S, B, y.device)
        return self.kern.mul_lm(y, tab1.index_select(2, jo).contiguous(),
                                tab2.index_select(2, jl).contiguous())

    # ---------------------------------------------------------- recursion
    def _base(self, x: torch.Tensor, a: int, inverse: bool, in_place: bool) -> torch.Tensor:
        """Size-2^a transforms along axis 0 of natural-order x (K7 folds the
        bit-reversal into its loads)."""
        if a == 0:
            return x.clone()
        return self.kern.ntt_base(x, self._packs[(a, inverse)], out=x if in_place else None)

    def _rec(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """(n, W) natural order -> (n, W) natural order.

        The recursion of the JAX plan, unrolled into a loop down the depths
        and one back up, so that each step holds only its input and its
        output: at 2^27 a buffer is 4 GiB.  Every buffer after the first
        transpose is the plan's own, so K7 and K9 update it in place."""
        n, W = x.shape
        parts = self.parts
        x = x.reshape(n, W, 1)
        B = 1
        lanes_b = []
        for d, a in enumerate(parts[:-1]):
            K = x.shape[0]
            A, C = 1 << a, K >> a
            # column NTTs of size A, batched over (j, b) lanes
            x = x.reshape(A, C, W, B).transpose(1, 2).contiguous().reshape(A, W, C * B)
            x = self._base(x, a, inverse, in_place=True)
            x = self._apply_twiddle(x, d, B, inverse)
            # row NTTs of size C, batched over (v, b) lanes
            x = x.reshape(A, W, C, B).permute(2, 1, 0, 3).contiguous().reshape(C, W, A * B)
            lanes_b.append(B)
            B = A * B
        x = self._base(x, parts[-1], inverse, in_place=len(parts) > 1)
        for d in reversed(range(len(parts) - 1)):
            A, B = 1 << parts[d], lanes_b[d]
            C = x.shape[0]
            # output index u*A + v at x[u, :, v*B + b]
            x = x.reshape(C, W, A, B).transpose(1, 2).contiguous().reshape(C * A, W, B)
        return x.reshape(n, W)

    def _check(self, x: torch.Tensor) -> None:
        W = self.spec.nwords
        if x.dtype != torch.int32 or x.shape != (self.n, W):
            raise ValueError(f"want ({self.n}, {W}) int32, got {tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, plan on {self.device}")

    # ------------------------------------------------------------- public
    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT: (n, W) int32 Montgomery words -> same."""
        self._check(x)
        return self._rec(x.contiguous(), False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT (n^-1 folded into the depth-0 T1 of multi-level
        plans, one K1 pass otherwise)."""
        self._check(x)
        out = self._rec(x.contiguous(), True)
        if len(self.parts) == 1:
            out = self.field.mul(out, self._ninv_mont)
        return out
