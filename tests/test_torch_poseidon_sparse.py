"""The sparse form of the Poseidon permutation (blaze_tpu_torch/hash/params.py
SparseForm, the schedule K10 runs) against the dense permutation, in exact
Python ints: the port's oracle (oracle/poseidon_ref.py) and blaze_tpu's
own permutation (its fused Pallas kernel in interpret mode at t = 9, its
portable Poseidon at t = 12).  t = 9 and 12 on the three scalar fields,
random states and states at p - 1, a CSV-loaded instance, and an instance
whose MDS has a singular lower-right block, which has no sparse form and
keeps the dense rounds.  Every comparison is exact.
"""
import random

import numpy as np
import pytest

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS
from blaze_tpu.hash import Poseidon as RefPoseidon, generate_params as ref_generate_params
from blaze_tpu.hash.kernels import PoseidonKernels as RefKernels
from blaze_tpu_torch.fields import FIELDS
from blaze_tpu_torch.hash import (
    PoseidonKernels,
    generate_params,
    params_from_csv,
    params_from_reference,
)
from blaze_tpu_torch.oracle.poseidon_ref import (
    poseidon_permutation_ref,
    poseidon_permutation_sparse_ref,
)

SCALAR_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")


def states(spec, t, n, seed):
    """p - 1 throughout, then random canonical states."""
    rng = random.Random(seed)
    return [[spec.p - 1] * t] + [[rng.randrange(spec.p) for _ in range(t)]
                                 for _ in range(n - 1)]


def singular_block(params):
    """`params` with row 2 of the MDS copied from row 1 past column 0: the
    lower-right (t-1) x (t-1) block is singular, so there is no sparse form."""
    mds = [list(row) for row in params.mds]
    mds[2][1:] = mds[1][1:]
    return params_from_reference(params.spec, params.t, params.alpha, params.r_f, params.r_p,
                                 params.round_constants, mds)


@pytest.mark.parametrize("t", [9, 12])
@pytest.mark.parametrize("field", SCALAR_FIELDS)
def test_sparse_schedule_matches_dense(field, t):
    params = generate_params(FIELDS[field], t)
    sf = params.sparse
    assert sf is not None and PoseidonKernels.for_params(params).sparse
    assert (len(sf.rc_full), len(sf.rc_partial), len(sf.rows), len(sf.cols)) == \
        (params.r_f, params.r_p, params.r_p, params.r_p)
    assert all(len(c) == t - 1 for c in sf.cols) and all(len(r) == t for r in sf.rows)
    for s in states(params.spec, t, 4, seed=t):
        assert poseidon_permutation_sparse_ref(params, s) == poseidon_permutation_ref(params, s)


def test_sparse_schedule_matches_blaze_tpu():
    """blaze_tpu's fused permutation in interpret mode (t = 9) and its
    portable Poseidon (t = 12) on bls12_381_fr, Montgomery words out, against
    the sparse schedule's ints."""
    spec, ref_spec = FIELDS["bls12_381_fr"], REF_FIELDS["bls12_381_fr"]
    rinv = pow(spec.r, -1, spec.p)
    for t in (9, 12):
        ref = ref_generate_params(ref_spec, t)
        port = params_from_reference(spec, t, ref.alpha, ref.r_f, ref.r_p,
                                     ref.round_constants, ref.mds)
        ss = states(spec, t, 2, seed=20 + t)
        limbs = np.stack([np.stack([np.frombuffer((v * spec.r % spec.p).to_bytes(32, "little"),
                                                  "<u2") for v in s]) for s in ss])
        limbs = jnp.asarray(limbs.astype(np.uint32))                        # (B, t, L)
        if t == 9:
            out = RefKernels.for_params(ref, interpret=True).permute_lm(
                jnp.moveaxis(limbs, 0, -1))                                   # (t, L, B)
            out = np.moveaxis(np.asarray(out), -1, 0)
        else:
            out = np.asarray(RefPoseidon(ref).permute(limbs))
        got = [[int.from_bytes(np.asarray(el, "<u2").tobytes(), "little") * rinv % spec.p
                for el in st] for st in out]
        assert got == [poseidon_permutation_sparse_ref(port, s) for s in ss]


def test_sparse_schedule_of_csv_instance(tmp_path):
    """Constants and a Cauchy MDS (x_i = 2i + 1, y_j = 2j + 40) other than
    generate_params', through params_from_csv."""
    spec, t = FIELDS["bn254_fr"], 9
    rng = random.Random(5)
    rc = [rng.randrange(spec.p) for _ in range((8 + 63) * t)]
    mds = [pow(2 * i + 1 + 2 * j + 40, -1, spec.p) for i in range(t) for j in range(t)]
    path = tmp_path / "consts.csv"
    path.write_text("\n".join(str(v) for v in rc + mds))
    params = params_from_csv(spec, str(path), t)
    assert params.sparse is not None
    for s in states(spec, t, 3, seed=6):
        assert poseidon_permutation_sparse_ref(params, s) == poseidon_permutation_ref(params, s)


@pytest.mark.parametrize("t", [9, 12])
def test_singular_block_keeps_dense_rounds(t):
    params = singular_block(generate_params(FIELDS["bls12_381_fr"], t))
    assert params.sparse is None
    k = PoseidonKernels.for_params(params)
    assert not k.sparse
    assert k._block.size == ((params.r_f + params.r_p) * t + t * t + 1) * 8 + k._nm * 9
    with pytest.raises(ValueError):
        poseidon_permutation_sparse_ref(params, [0] * t)
