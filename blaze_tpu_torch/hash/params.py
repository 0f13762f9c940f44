"""Poseidon parameter generation (Grain LFSR + Cauchy MDS).

The port's own copy of blaze_tpu/hash/params.py: the reference treats
Poseidon constants as an opaque CSV instruction stream loaded into FPGA
program memory (`/root/reference/src/ingo_hash/poseidon_api.rs:205-243`) and
never validates hash values.  Here constants are generated with the
standard Grain-LFSR procedure from the Poseidon paper's reference
implementation (generate_parameters_grain.sage), so the instance is fully
specified, reproducible, and oracle-checkable.

The device tables (`rc_mont`, `mds_mont`) are Montgomery forms as int32
words, the port's element layout.  `sparse_form` derives the same
permutation with sparse partial rounds (Grassi et al., "Poseidon",
USENIX Security 2021, eprint 2019/458, appendix B), exactly in ints mod p.  `params_from_reference` carries an
instance's constants — the Poseidon "weights" — across from another
package's fields given as plain ints or numpy arrays.
"""
from __future__ import annotations

import csv
import dataclasses
import functools

import numpy as np

from ..fields.spec import FIELDS, FieldSpec, int_to_words
from ..utils.errors import DataError

# Partial-round counts for alpha=5, M=128, ~254/255-bit prime fields,
# R_F = 8 (circomlib's table, t = 2..17).
_RP_TABLE = {
    2: 56, 3: 57, 4: 56, 5: 60, 6: 60, 7: 63, 8: 64, 9: 63,
    10: 60, 11: 66, 12: 60, 13: 65, 14: 70, 15: 60, 16: 64, 17: 68,
}


def _grain_bits(field_bits: int, t: int, r_f: int, r_p: int):
    """Self-shrinking Grain LFSR bit generator (Poseidon reference init)."""
    def bits_of(value, width):
        return [(value >> (width - 1 - i)) & 1 for i in range(width)]

    state = (
        bits_of(1, 2)            # field tag: 1 = prime field
        + bits_of(0, 4)          # sbox tag: 0 = x^alpha
        + bits_of(field_bits, 12)
        + bits_of(t, 12)
        + bits_of(r_f, 10)
        + bits_of(r_p, 10)
        + [1] * 30
    )
    assert len(state) == 80

    def update():
        new = (
            state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        )
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()

    while True:
        b1 = update()
        b2 = update()
        if b1:
            yield b2


def _sample_field_elements(gen, count: int, p: int, field_bits: int):
    out = []
    while len(out) < count:
        v = 0
        for _ in range(field_bits):
            v = (v << 1) | next(gen)
        if v < p:
            out.append(v)
    return out


@dataclasses.dataclass(frozen=True)
class PoseidonParams:
    """One fully-specified Poseidon instance over a prime field."""

    spec: FieldSpec
    t: int
    alpha: int
    r_f: int           # full rounds (total)
    r_p: int           # partial rounds
    round_constants: tuple  # ((r_f + r_p) * t,) python ints
    mds: tuple              # t x t python ints

    @property
    def rate(self) -> int:
        return self.t - 1

    # ------------------------------------------------- device-ready tables
    @functools.cached_property
    def rc_mont(self) -> np.ndarray:
        """(rounds, t, W) int32 words, Montgomery form."""
        return mont_words(self.spec, self.round_constants).reshape(
            self.r_f + self.r_p, self.t, self.spec.nwords)

    @functools.cached_property
    def mds_mont(self) -> np.ndarray:
        """(t, t, W) int32 words, Montgomery form."""
        return mont_words(self.spec, self.mds)

    @functools.cached_property
    def sparse(self) -> "SparseForm | None":
        """The permutation with sparse partial rounds, or None where it
        does not exist (see `sparse_form`)."""
        return sparse_form(self)


def mont_words(spec: FieldSpec, vals) -> np.ndarray:
    """Nested sequences of canonical ints -> int32 words of their Montgomery
    forms, shape (*shape, W)."""
    arr = np.asarray(vals, dtype=object)
    W = spec.nwords
    flat = [int_to_words(int(v) * spec.r % spec.p, W) for v in arr.reshape(-1)]
    return np.stack(flat).view(np.int32).reshape(*arr.shape, W)


def _matmul(a, b, p: int):
    return [[sum(x * y for x, y in zip(row, col)) % p for col in zip(*b)] for row in a]


def _inverse(m, p: int):
    """Inverse of the square matrix m mod p (Gauss-Jordan), or None when
    m is singular."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for c in range(n):
        piv = next((r for r in range(c, n) if a[r][c] % p), None)
        if piv is None:
            return None
        a[c], a[piv] = a[piv], a[c]
        inv = pow(a[c][c], -1, p)
        a[c] = [v * inv % p for v in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(v - f * w) % p for v, w in zip(a[r], a[c])]
    return [row[n:] for row in a]


@dataclasses.dataclass(frozen=True)
class SparseForm:
    """A Poseidon permutation rewritten with sparse partial rounds.

    Full round r (r < r_f/2, or the r_f/2 after the partial rounds, in
    order): s += rc_full[r]; x^5 on every element; s = M s, except that the
    last full round before the partial rounds mixes by `pre` in place of M.
    Partial round k: s_0 += rc_partial[k]; s_0 = s_0^5; then the sparse
    matrix [[rows[k]], [cols[k] | I]]: s_0' = sum_j rows[k][j] s_j and
    s_i' = s_i + cols[k][i-1] s_0 for i >= 1.  All canonical ints.
    """

    rc_full: tuple     # (r_f, t)
    rc_partial: tuple  # (r_p,)
    pre: tuple         # (t, t)
    rows: tuple        # (r_p, t)
    cols: tuple        # (r_p, t - 1)


def sparse_form(params: PoseidonParams) -> "SparseForm | None":
    """The sparse-partial-round form of `params`, exactly in ints mod p.

    Constants move forward: in a partial round only s_0 meets the S-box, so
    the constants of s_1.. pass through it and, multiplied by M, join the
    next round's constants; each partial round keeps one scalar, and the
    last one's remainder joins the first full round after them.

    Matrices move backward: a dense N = [[n00, n^T], [w, N']] factors as
    A diag(1, N') with A = [[n00, n^T N'^-1], [w, I]] sparse; diag(1, N')
    commutes with the partial round's S-box and scalar constant, so it
    joins the round before as diag(1, N') M.  From the last partial round
    back, N' is a power of M's lower-right (t-1) x (t-1) block, and what is
    left after the first partial round mixes the last full round before
    them (`pre`).

    None when that block is singular (the partial rounds then stay dense),
    or when there is no partial round or no full round before them.
    """
    p, t, half, r_p = params.spec.p, params.t, params.r_f // 2, params.r_p
    if r_p < 1 or half < 1:
        return None
    mds = [list(row) for row in params.mds]
    if _inverse([row[1:] for row in mds[1:]], p) is None:
        return None
    rc = [list(params.round_constants[r * t:(r + 1) * t])
          for r in range(params.r_f + r_p)]
    scalars = []
    for r in range(half, half + r_p):
        scalars.append(rc[r][0])
        moved = [sum(m * c for m, c in zip(row[1:], rc[r][1:])) for row in mds]
        rc[r + 1] = [(a + b) % p for a, b in zip(rc[r + 1], moved)]
    rows, cols = [], []
    n = mds
    for _ in range(r_p):
        lower = [row[1:] for row in n[1:]]
        first = _matmul([n[0][1:]], _inverse(lower, p), p)[0]
        rows.append(tuple([n[0][0]] + first))
        cols.append(tuple(row[0] for row in n[1:]))
        n = _matmul([[1] + [0] * (t - 1)] + [[0] + row for row in lower], mds, p)
    return SparseForm(
        rc_full=tuple(tuple(v) for v in rc[:half] + rc[half + r_p:]),
        rc_partial=tuple(scalars),
        pre=tuple(tuple(row) for row in n),
        rows=tuple(reversed(rows)),
        cols=tuple(reversed(cols)),
    )


def generate_params(
    spec: FieldSpec,
    t: int,
    alpha: int = 5,
    r_f: int = 8,
    r_p: int | None = None,
) -> PoseidonParams:
    """Standard Grain-LFSR constants + Cauchy MDS for (field, t)."""
    p = spec.p
    field_bits = spec.bits
    if r_p is None:
        r_p = _RP_TABLE.get(t, 68)
    gen = _grain_bits(field_bits, t, r_f, r_p)
    rc = _sample_field_elements(gen, (r_f + r_p) * t, p, field_bits)
    # Cauchy matrix mds[i][j] = 1 / (x_i + y_j), x_i = i, y_j = t + j
    mds = tuple(
        tuple(pow((i + (t + j)) % p, -1, p) for j in range(t))
        for i in range(t)
    )
    return PoseidonParams(
        spec=spec,
        t=t,
        alpha=alpha,
        r_f=r_f,
        r_p=r_p,
        round_constants=tuple(rc),
        mds=mds,
    )


def params_from_reference(spec, t: int, alpha: int, r_f: int, r_p: int,
                          round_constants, mds) -> PoseidonParams:
    """The port's PoseidonParams from another implementation's instance
    fields (plain ints or numpy arrays): round_constants ((r_f + r_p) * t,)
    and the t x t mds, canonical integers below p.  spec: a FieldSpec or
    its name."""
    spec = spec if isinstance(spec, FieldSpec) else FIELDS[spec]
    rc = tuple(int(c) for c in np.asarray(round_constants, dtype=object).reshape(-1))
    m = np.asarray(mds, dtype=object)
    if len(rc) != (r_f + r_p) * t or m.shape != (t, t):
        raise ValueError(
            f"want {(r_f + r_p) * t} round constants and a ({t}, {t}) MDS, got "
            f"{len(rc)} and {m.shape}"
        )
    mds_t = tuple(tuple(int(v) for v in row) for row in m)
    if not all(0 <= v < spec.p for v in rc + sum(mds_t, ())):
        raise ValueError("constants must be canonical (0 <= value < p)")
    return PoseidonParams(spec=spec, t=int(t), alpha=int(alpha), r_f=int(r_f),
                          r_p=int(r_p), round_constants=rc, mds=mds_t)


def params_from_csv(spec: FieldSpec, path: str, t: int, **kw) -> PoseidonParams:
    """Load constants from a CSV of decimal values (reference-compatible:
    poseidon_api.rs:205-243 streams CSV records of decimal big-ints).

    Layout: first (r_f + r_p) * t values are round constants, next t*t are
    the row-major MDS matrix.
    """
    vals = []
    try:
        with open(path) as fh:
            for row in csv.reader(fh):
                try:
                    vals.extend(int(v) for v in row if v.strip())
                except ValueError as e:
                    raise DataError(
                        f"non-integer value in {path!r}: {e}"
                    ) from e
    except OSError as e:
        raise DataError(f"cannot read constants CSV {path!r}: {e}") from e
    r_f = kw.get("r_f", 8)
    r_p = kw.get("r_p", _RP_TABLE.get(t, 68))
    nrc = (r_f + r_p) * t
    if len(vals) < nrc + t * t:
        raise DataError(
            f"CSV {path!r} has {len(vals)} values, need {nrc + t * t} "
            f"for t={t}"
        )
    rc = tuple(v % spec.p for v in vals[:nrc])
    mds_flat = [v % spec.p for v in vals[nrc : nrc + t * t]]
    mds = tuple(tuple(mds_flat[i * t + j] for j in range(t)) for i in range(t))
    return PoseidonParams(
        spec=spec, t=t, alpha=kw.get("alpha", 5), r_f=r_f, r_p=r_p,
        round_constants=rc, mds=mds,
    )
