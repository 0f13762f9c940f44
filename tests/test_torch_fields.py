"""The port's field layer (blaze_tpu_torch.fields) against the JAX package.

Same inputs, made with seeded numpy, go through blaze_tpu's Field (its
portable XLA path on the CPU), its in-kernel field library PallasFieldOps
(evaluated outside a kernel), Python integers, and the port's Field and
PlainFieldOps — the plain versions of the K1 kernel and of csrc/field.cuh.
Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu.fields.kernel_ops import PallasFieldOps
from blaze_tpu_torch.fields import FIELDS, Field, bytes_to_words, words_to_bytes
from blaze_tpu_torch.fields.kernel_ops import (
    PlainFieldOps,
    limbs16_to_words,
    words_to_limbs16,
)
from blaze_tpu_torch.fields.montmul import mont_mul_plain

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

M = 8


def rand_ints(p: int, n: int, seed: int, bound: int | None = None) -> list[int]:
    """n integers uniform in [0, bound or p), from seeded numpy words."""
    bound = bound or p
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, (bound.bit_length() + 95) // 32), dtype=np.uint64
    )
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % bound
            for row in words]


def to_words(vals, spec) -> torch.Tensor:
    arr = np.stack([
        np.frombuffer(v.to_bytes(spec.nbytes, "little"), dtype="<u4")
        for v in vals
    ])
    return torch.from_numpy(arr.view(np.int32).copy())


def to_limbs16(vals, spec) -> np.ndarray:
    return np.stack([
        np.frombuffer(v.to_bytes(spec.nbytes, "little"), dtype="<u2").astype(np.uint32)
        for v in vals
    ])


def words_ints(t: torch.Tensor) -> list[int]:
    return [int.from_bytes(r.tobytes(), "little")
            for r in t.numpy().view(np.uint32).reshape(t.shape[0], -1)]


def limbs_ints(a) -> list[int]:
    return [sum(int(v) << (16 * i) for i, v in enumerate(row))
            for row in np.asarray(a)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_ops_match_reference_and_ints(name):
    spec = FIELDS[name]
    p, R = spec.p, spec.r
    a_i = rand_ints(p, M, seed=1)
    b_i = rand_ints(p, M, seed=2)
    a_i[0], b_i[1] = 0, p - 1                      # edges: zero, p - 1
    f = Field(spec)
    a, b = to_words(a_i, spec), to_words(b_i, spec)
    rf = RefField(REF_FIELDS[name])
    ra, rb = jnp.asarray(to_limbs16(a_i, spec)), jnp.asarray(to_limbs16(b_i, spec))
    rinv = pow(R, -1, p)
    cases = {
        "add": (f.add(a, b), rf.add(ra, rb), [(x + y) % p for x, y in zip(a_i, b_i)]),
        "sub": (f.sub(a, b), rf.sub(ra, rb), [(x - y) % p for x, y in zip(a_i, b_i)]),
        "neg": (f.neg(a), rf.neg(ra), [(-x) % p for x in a_i]),
        "mul": (f.mul(a, b), rf._mul_portable(ra, rb),
                [x * y * rinv % p for x, y in zip(a_i, b_i)]),
        "to_mont": (f.to_mont(a), rf.to_mont(ra), [x * R % p for x in a_i]),
        "from_mont": (f.from_mont(a), rf.from_mont(ra), [x * rinv % p for x in a_i]),
    }
    for op, (got, ref, ints) in cases.items():
        assert words_ints(got) == ints, (name, op)
        assert words_ints(got) == limbs_ints(ref), (name, op)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_k1_plain_matches_reference_portable_mul(name):
    """The plain version of K1 (fields/montmul.py) vs blaze_tpu's portable
    product, including operands up to R - 1 (top-word tracking)."""
    spec = FIELDS[name]
    a_i = rand_ints(spec.p, 16, seed=3, bound=spec.r)
    b_i = rand_ints(spec.p, 16, seed=4, bound=spec.p)
    got = mont_mul_plain(spec, to_words(a_i, spec), to_words(b_i, spec))
    ref = RefField(REF_FIELDS[name])._mul_portable(
        jnp.asarray(to_limbs16(a_i, spec)), jnp.asarray(to_limbs16(b_i, spec))
    )
    assert words_ints(got) == limbs_ints(ref)


@pytest.mark.parametrize("name,lazy", [
    ("bn254_fq", True), ("bls12_381_fq", True), ("bls12_377_fq", True),
    ("bn254_fr", False), ("bls12_381_fr", False),
])
def test_k0_plain_matches_pallas_field_ops(name, lazy):
    """PlainFieldOps (the twin of csrc/field.cuh) vs PallasFieldOps'
    _mont_mul / _add_f / _sub_f on values in the discipline's range
    (< 2p lazy, < p canonical): exact limbs."""
    spec = FIELDS[name]
    bound = (2 if lazy else 1) * spec.p
    a_i = rand_ints(spec.p, 128, seed=5, bound=bound)
    b_i = rand_ints(spec.p, 128, seed=6, bound=bound)
    ours = PlainFieldOps(spec, lazy=lazy)
    ref = PallasFieldOps(REF_FIELDS[name], lazy=lazy)
    fc = tuple(jnp.asarray(x) for x in ref.field_const_arrays())
    ra = jnp.asarray(to_limbs16(a_i, spec).T)            # (L, T) lanes-major
    rb = jnp.asarray(to_limbs16(b_i, spec).T)
    ta = torch.from_numpy(to_limbs16(a_i, spec).astype(np.int64))
    tb = torch.from_numpy(to_limbs16(b_i, spec).astype(np.int64))
    for got, want in [
        (ours.mul(ta, tb), ref._mont_mul(ra, rb, fc)),
        (ours.add(ta, tb), ref._add_f(ra, rb)),
        (ours.sub(ta, tb), ref._sub_f(ra, rb)),
    ]:
        assert np.array_equal(got.numpy(), np.asarray(want).T.astype(np.int64))


@pytest.mark.parametrize("name", ["bn254_fq", "bls12_381_fq"])
def test_word_codecs_are_views_of_limbs(name):
    spec = FIELDS[name]
    vals = rand_ints(spec.p, 5, seed=7)
    raw = b"".join(v.to_bytes(spec.nbytes, "little") for v in vals)
    words = bytes_to_words(raw, spec)
    assert words_ints(torch.from_numpy(words.view(np.int32))) == vals
    assert words_to_bytes(words, spec) == raw
    limbs = torch.from_numpy(to_limbs16(vals, spec).astype(np.int64))
    w = limbs16_to_words(limbs)
    assert torch.equal(words_to_limbs16(w), limbs)
    assert np.array_equal(w.numpy().view(np.uint32), words)
