"""Pure-python Poseidon oracle (same parameters as the device kernel).

The port's own copy of blaze_tpu/oracle/poseidon_ref.py.  Closes the
validation gap noted in SURVEY §4.3: the reference never checks hash values
against a software Poseidon; we do.
"""
from __future__ import annotations

from ..hash.params import PoseidonParams


def poseidon_permutation_ref(params: PoseidonParams, state):
    """state: list of t python ints (canonical). Returns new state."""
    p = params.spec.p
    t = params.t
    rc = params.round_constants
    mds = params.mds
    s = [x % p for x in state]
    half_f = params.r_f // 2
    rounds = params.r_f + params.r_p

    for r in range(rounds):
        s = [(x + rc[r * t + i]) % p for i, x in enumerate(s)]
        if r < half_f or r >= half_f + params.r_p:
            s = [pow(x, params.alpha, p) for x in s]
        else:
            s[0] = pow(s[0], params.alpha, p)
        s = [
            sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)
        ]
    return s


def poseidon_permutation_sparse_ref(params: PoseidonParams, state):
    """The same permutation through `params.sparse` (hash/params.py
    SparseForm): dense full rounds, sparse partial rounds.  state: t
    canonical ints."""
    sf, p, t = params.sparse, params.spec.p, params.t
    if sf is None:
        raise ValueError("this instance has no sparse form")
    half = params.r_f // 2
    s = [x % p for x in state]

    def full(s, c, m):
        s = [pow((x + k) % p, params.alpha, p) for x, k in zip(s, c)]
        return [sum(a * x for a, x in zip(row, s)) % p for row in m]

    for r in range(half):
        s = full(s, sf.rc_full[r], sf.pre if r == half - 1 else params.mds)
    for k in range(params.r_p):
        x0 = pow((s[0] + sf.rc_partial[k]) % p, params.alpha, p)
        s = [x0] + s[1:]
        s = ([sum(a * x for a, x in zip(sf.rows[k], s)) % p]
             + [(x + w * x0) % p for x, w in zip(s[1:], sf.cols[k])])
    for r in range(half, params.r_f):
        s = full(s, sf.rc_full[r], params.mds)
    return s


def poseidon_hash_ref(params: PoseidonParams, inputs, domain_tag: int = 0):
    """Sponge convention matching Poseidon.hash: state = [tag, inputs...],
    output = state[1] after one permutation."""
    if len(inputs) != params.rate:
        raise ValueError(f"want {params.rate} inputs, got {len(inputs)}")
    state = [domain_tag] + list(inputs)
    return poseidon_permutation_ref(params, state)[1]


def merkle_tree_ref(leaf_params, node_params, columns, height: int):
    """Full 8-ary tree oracle. columns: list of 11-int lists."""
    layer = [poseidon_hash_ref(leaf_params, col) for col in columns]
    layers = [layer]
    while len(layer) > 1:
        layer = [
            poseidon_hash_ref(node_params, layer[i : i + 8])
            for i in range(0, len(layer), 8)
        ]
        layers.append(layer)
    return layers
