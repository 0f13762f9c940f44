"""Composed NTT: Cooley-Tukey recursion over the base kernels (K7-K9).

Port of blaze_tpu/ntt/fused.py FusedNTT.  A size-2^logn transform is split
into balanced factors of at most 2^KLOG points (`split_parts`); each factor
is one K7 launch over all its sub-transforms, and between factors sits an
inter-level twiddle (K9, or K8 for narrow cells, on twiddles the plan
keeps in element order).  The reference moves the data between levels
with a 16-bank HBM shuffle
(`blaze/src/ingo_ntt/ntt_data.rs:80-156`) and the JAX package with
transposes; here K7 reads and writes each level through its strides, and
no level moves the data otherwise.

The inter-level twiddle W^(j*v) of a K = A*C split is applied from two
SPLIT TABLES: with j = jo*S + jl (S ~ sqrt(C)),

    W^(j*v) = T1[v, jo] * T2[v, jl],   T1 from W^(S*m), T2 from W^m,

each table A*C/S or A*S entries (8 MiB at 2^27), never the K-entry matrix.
n^-1 of the inverse is folded into the depth-0 inverse T1.

Storage order.  With parts a_0..a_{D-1} (A_e = 2^a_e), input index
i = sum_e i_e S_e (S_e = prod_{f>e} A_f, i_0 most significant) and
output index k = sum_e k_e P_e (P_e = prod_{f<e} A_f).  Level d transforms
digit i_d into k_d for every value of the other digits.  Between levels an
element lives in the plan's buffer at row sum_e digit_e P_e — digit e at
the output's weight, whether it is still i_e or already k_e — so level d
(d >= 1) reads and writes the same rows (in place), and after the last
level the buffer is in natural order.  Level 0 reads the caller's input in
natural order and writes the buffer (the input is left as it was).  The
plan holds two buffers, the input and its own.  An (n, W) buffer of int32
words keeps an element's 32 bytes together, so K7's strided reads and
writes move whole sectors.

Batches.  `ntt_batch` / `intt_batch` run B independent transforms of the
plan's size in the same launches: one K7 launch per level over all B, one
K9 launch per twiddle.  Point i of transform b is read at row i*es + b*bs
of the caller's buffer (es, bs powers of two: the four-step's columns are
read through their stride, with no transpose copy), and the result is
written as (B, n) rows or, `minor`, as (n, B) rows.  The batch is one more
lane field of each level's maps (`batch_level`): the transform index's
bits sit below the level's lane bits for (n, B) rows (neighbouring lanes
on neighbouring rows) and above them for (B, n) rows.  K9 needs no batch
field: an element's position inside its transform is its row shifted
right by log2(B) ((n, B) rows) or its row's low log2(n) bits ((B, n)
rows), so only its map's shifts move.  What does not fit: a batched plan
of more than MAX_FIELDS = 6 levels (level 0's output map holds one field
per later level and the batch field), and a count that is not a power of
two (NTTPlan runs such a batch as power-of-two pieces).  Batched plans
take K9 at every level; the K8 fallback serves only the single transform.

Left out from the JAX plan: the lane-expanded packs and u16 storage (Mosaic
and TPU-tiling workarounds), the u16 donated entry points and the blocked
layout (the TPU pads a (K, 16) u16 array 8x; (n, 8) int32 words already
take exactly 32 B per element).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields.mont import Field
from ..fields.spec import FieldSpec, int_to_words
from .kernels import MAX_FIELDS, MAX_LOGK, NTTKernels, TileMap, _log2, twiddle_cols

__all__ = ["FusedNTT", "Level", "batch_level", "split_parts", "tables_from_reference"]

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
    arrays.  Returns ({key: (A, W) int32}, {key: ((A, J, W), (A, S, W))
    int32}) — FusedNTT._packs / _tabs of the port on the CPU (every table
    element-contiguous)."""
    out_packs = {k: _u16_to_words(np.asarray(v)[:, :, :1])[:, :, 0].contiguous()
                 for k, v in packs.items()}
    out_tabs = {k: tuple(_u16_to_words(t).transpose(1, 2).contiguous() for t in (t1, t2))
                for k, (t1, t2) in tabs.items()}
    return out_packs, out_tabs


class Level(NamedTuple):
    """One level of a plan: K7 over `lanes` transforms of 2^a points, read
    through `xmap` and written through `omap`; after it (all but the last
    level) the twiddle, row v = (pos >> vshift) % 2^a and column j from the
    bit `fields` (src, wid, dst) of each element's row pos."""

    a: int
    lanes: int
    xmap: TileMap
    omap: TileMap
    vshift: int
    fields: tuple


def plan_levels(parts: list[int]) -> list[Level]:
    """The levels of a plan over `parts` in the storage order of the module
    docstring: level d's lane l = J_d * P_d + lo, where lo (< P_d) holds
    the digits already transformed and J_d (< S_d) the input digits still
    to go, i_e at weight S_e."""
    D, logn = len(parts), sum(parts)
    logP = [sum(parts[:e]) for e in range(D)]
    logS = [sum(parts[e + 1:]) for e in range(D)]
    levels = []
    for d, a in enumerate(parts):
        P = 1 << logP[d]
        # lo at weight 1, then each digit i_e (bits logP_d + logS_e up of
        # the lane) at the output's weight P_e
        lane = ((0, logP[d], 0),) if P > 1 else ()
        lane += tuple((logP[d] + logS[e], parts[e], logP[e]) for e in range(d + 1, D))
        omap = TileMap(P, lane)
        lanes = 1 << (logn - a)
        xmap = TileMap.rows(lanes) if d == 0 else omap
        fields = tuple((logP[e], parts[e], logS[e]) for e in range(d + 1, D))
        levels.append(Level(a, lanes, xmap, omap, logP[d], fields))
    return levels


def _lay_out(m: TileMap, log_lanes: int, logB: int, es: int, bs: int, low: bool) -> TileMap:
    """A level's map of one transform (lane l < 2^log_lanes at logical row
    k*ks + field_sum(l)) for B = 2^logB transforms at physical row
    logical*es + b*bs, lane l*B + b (`low`) or b*2^log_lanes + l."""
    les, lbs = es.bit_length() - 1, bs.bit_length() - 1
    if low:
        fields = ((0, logB, lbs),) + tuple((s + logB, w, d + les) for s, w, d in m.fields)
    else:
        fields = tuple((s, w, d + les) for s, w, d in m.fields) + ((log_lanes, logB, lbs),)
    return TileMap(m.ks * es, tuple(f for f in fields if f[1]))


def batch_level(lv: Level, d: int, logn: int, B: int, src: tuple, minor: bool) -> Level:
    """Level `d` of a plan over 2^logn points for B = 2^k transforms: read
    (level 0) point i of transform b at row i*src[0] + b*src[1], and keep
    the plan's buffer as (n, B) rows (`minor`) or (B, n) rows."""
    logB = B.bit_length() - 1
    log_lanes = lv.lanes.bit_length() - 1
    es, bs = (B, 1) if minor else (1, 1 << logn)
    omap = _lay_out(lv.omap, log_lanes, logB, es, bs, minor)
    if d == 0:
        one = TileMap(lv.lanes, ((0, log_lanes, 0),) if log_lanes else ())
        xmap = _lay_out(one, log_lanes, logB, src[0], src[1], minor)
    else:
        xmap = omap
    shift = es.bit_length() - 1
    return Level(lv.a, lv.lanes * B, xmap, omap, lv.vshift + shift,
                 tuple((s + shift, w, dd) for s, w, dd in lv.fields))


class FusedNTT:
    """NTT plan for one (field, logn), its tables on `device`.  `.ntt` /
    `.intt` map (n, W) int32 canonical Montgomery words, natural order in
    and out, to a new (n, W) tensor; the input is left as it was.

    klog caps the parts (KLOG = 9 on every client).  A plan of more than
    MAX_FIELDS + 1 = 7 levels is refused, since level 0's maps hold one
    lane field per later level: klog 3 from logn 22, klog 2 from logn 15
    (blaze_tpu's FusedNTT builds those).  At klog 9 every field's plan
    fits (6 levels at bls12_377_fr's 2-adicity 47)."""

    # Cells narrower than this many lanes take the K8 fallback on the
    # twiddles in element order (only small plans, 2^10-2^19); tests may
    # lower it to force K9 at small sizes.
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
        if len(self.parts) > MAX_FIELDS + 1:
            # level 0's maps hold one lane field per later level
            raise ValueError(f"{len(self.parts)} levels: K7's maps hold at most "
                             f"{MAX_FIELDS + 1} (a larger klog cuts the count)")
        self.levels = plan_levels(self.parts) if logn else []
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
        # tab1[v, jo] * tab2[v, jl], each table (A, J or S, W) elements.
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
                    t1[idx1].contiguous(),                        # (A, J, W)
                    t2[idx2].contiguous(),                        # (A, S, W)
                )

        # ---- the small-plan fallback's twiddles, one (n, W) tensor per
        # (depth, inverse) whose cell K8 serves
        self._rows = {}
        for d in range(len(self.parts) - 1):
            if self._takes_k8(d):
                for inv in (False, True):
                    self._twiddle_rows(d, inv)

    # ------------------------------------------------------------ twiddle
    def _takes_k8(self, depth: int) -> bool:
        """Whether level `depth`'s twiddle cell is narrower than
        _TWMUL_MIN_LANES (the K8 fallback)."""
        lv = self.levels[depth]
        S = self._tabs[(depth, False)][1].shape[1]
        cell = S if lv.vshift == 0 else 1 << lv.vshift
        return cell < self._TWMUL_MIN_LANES

    def _twiddle_rows(self, depth: int, inverse: bool) -> torch.Tensor:
        """The twiddle of every row of level `depth`'s buffer, in element
        order: row pos holds tab1[v, jo] * tab2[v, jl], one Montgomery product
        (K1; canonical products are associative mod p, so K8's y * rows
        equals y * tab1 * tab2 word for word).  Built with the plan for the
        depths K8 serves, n x 32 B each (2 MiB at 2^16, 16 MiB at 2^19)."""
        key = (depth, inverse)
        rows = self._rows.get(key)
        if rows is None:
            lv = self.levels[depth]
            tab1, tab2 = self._tabs[key]
            v, jo, jl = twiddle_cols(self.n, lv.a, lv.vshift, lv.fields,
                                     tab2.shape[1].bit_length() - 1, self.device)
            rows = self._rows[key] = self.field.mul(tab1[v, jo], tab2[v, jl])
        return rows

    def _apply_twiddle(self, y: torch.Tensor, depth: int, inverse: bool,
                       lv: Level) -> torch.Tensor:
        """Multiply each element of the plan's buffer y, at level `lv`'s row
        v and column j, by W^(j*v) = tab1[v, j//S] * tab2[v, j%S], in
        place: on K9 from the split tables, or for a narrow cell of the
        single transform (lv is self.levels[depth]) on K8 with the plan's
        element-order twiddles (two operands, one launch)."""
        if lv is not self.levels[depth] or not self._takes_k8(depth):
            tab1, tab2 = self._tabs[(depth, inverse)]
            return self.kern.twiddle_mul(y, tab1, tab2, lv.vshift, lv.fields, out=y)
        n, W = y.shape
        rows = y.view(n, W, 1)
        self.kern.mul_lm(rows, self._twiddle_rows(depth, inverse).view(n, W, 1), out=rows)
        return y

    # ---------------------------------------------------------- recursion
    def _rec(self, x: torch.Tensor, inverse: bool, levels: list, rows: int) -> torch.Tensor:
        """Run `levels` (self.levels, or their batch_level forms) on x into
        a new (rows, W) buffer.

        The recursion of the JAX plan as a loop over its levels: level 0
        reads x and writes the plan's buffer, every later level and twiddle
        updates that buffer in place, so a transform holds two buffers (4
        GiB each at 2^27) and moves no data between levels."""
        if not levels:
            return x.clone()
        y = torch.empty((rows, x.shape[1]), dtype=x.dtype, device=x.device)
        for d, lv in enumerate(levels):
            self.kern.ntt_base(x if d == 0 else y, self._packs[(lv.a, inverse)], lv.lanes,
                               lv.xmap, out=y, omap=lv.omap)
            if d + 1 < len(levels):
                y = self._apply_twiddle(y, d, inverse, lv)
        return y

    def _check(self, x: torch.Tensor) -> None:
        W = self.spec.nwords
        if x.dtype != torch.int32 or x.shape != (self.n, W):
            raise ValueError(f"want ({self.n}, {W}) int32, got {tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, plan on {self.device}")

    def _batch(self, x: torch.Tensor, inverse: bool, count: int, stride: int,
               batch_stride, minor: bool) -> torch.Tensor:
        W = self.spec.nwords
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != W:
            raise ValueError(f"want (rows, {W}) int32, got {tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, plan on {self.device}")
        batch_stride = self.n * stride if batch_stride is None else batch_stride
        logB = _log2(count, "count")
        _log2(stride, "stride")
        _log2(batch_stride, "batch_stride")
        if logB and len(self.levels) > MAX_FIELDS:
            raise ValueError(f"a batched plan of {len(self.levels)} levels needs that many "
                             f"lane fields, K7's maps hold {MAX_FIELDS}")
        x = x.contiguous()
        if not self.levels:                          # n = 1: a copy of each transform
            idx = torch.arange(count, device=x.device) * batch_stride
            return x[idx].clone()
        levels = [batch_level(lv, d, self.logn, count, (stride, batch_stride), minor)
                  for d, lv in enumerate(self.levels)]
        out = self._rec(x, inverse, levels, self.n * count)
        if inverse and len(self.parts) == 1:
            out = self.field.mul(out, self._ninv_mont)
        return out

    # ------------------------------------------------------------- public
    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT: (n, W) int32 Montgomery words -> same."""
        self._check(x)
        return self._rec(x.contiguous(), False, self.levels, self.n)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT (n^-1 folded into the depth-0 T1 of multi-level
        plans, one K1 pass otherwise)."""
        self._check(x)
        out = self._rec(x.contiguous(), True, self.levels, self.n)
        if len(self.parts) == 1:
            out = self.field.mul(out, self._ninv_mont)
        return out

    def ntt_batch(self, x: torch.Tensor, count: int, stride: int = 1,
                  batch_stride: int | None = None, minor: bool = False) -> torch.Tensor:
        """`count` forward NTTs in one pass of the plan's launches.

        x: (rows, W) int32 Montgomery words on the plan's device; point i of
        transform b at row i*stride + b*batch_stride (powers of two; default
        batch_stride n*stride, (count, n) rows at stride 1), count a power of
        two.  Returns a new (count*n, W) tensor in natural order: transform
        b's point k at row b*n + k, or with `minor` at row k*count + b."""
        return self._batch(x, False, count, stride, batch_stride, minor)

    def intt_batch(self, x: torch.Tensor, count: int, stride: int = 1,
                   batch_stride: int | None = None, minor: bool = False) -> torch.Tensor:
        """`count` inverse NTTs, laid out as in `ntt_batch`."""
        return self._batch(x, True, count, stride, batch_stride, minor)
