"""Judgements of results made on the card, against independent oracles.

`evaluate_on_card` evaluates a polynomial at powers of a root of unity
with K1 products and integer sums, no NTT kernel; `word_ints` reads words
back as Python ints.  `parse_records`, `tree_ids` and `check_tree` read a
TREE_C record stream and hold sampled nodes to oracle/poseidon_ref.
`pipeline_terms`, `coeff_batch` and `pipeline_expected` make the proof
pipeline's coefficient batches and their geometric MSM oracles.
chip_smoke.py judges its NTT, tree and pipeline phases with them.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from ..fields import Field, int_to_words
from ..fields.kernel_ops import words_to_limbs16
from ..hash import LEAF_ARITY, generate_params, num_tree_nodes
from ..pipeline import geometric_msm_oracle
from .ec import ECOracle
from .poseidon_ref import poseidon_hash_ref


# --------------------------------------------------------------------- NTT
def word_ints(words) -> list:
    """(n, W) uint32 words -> Python ints."""
    return [int.from_bytes(row.tobytes(), "little") for row in words]


def evaluate_on_card(spec, x, root: int, ks, chunk: int = 1 << 22) -> list:
    """sum_i x[i] root^(ik) mod p for each k, without any NTT kernel: per
    chunk, Field.powers of root^k (K1) times root^(k c0), times x (K1:
    canonical x against a Montgomery power gives the canonical product),
    then the products' 16-bit limbs summed as integers on x's device."""
    f, p, W = Field(spec), spec.p, spec.nwords

    def mont(v):
        return torch.as_tensor(int_to_words(v * spec.r % p, W).view(np.int32),
                               device=x.device)

    chunk = min(chunk, x.shape[0])
    out = []
    for k in ks:
        wk = pow(root, k, p)
        base = f.powers(mont(wk), chunk)
        acc = 0
        for c0 in range(0, x.shape[0], chunk):
            xs = x[c0:c0 + chunk]
            prod = f.mul(xs, f.mul(base[: xs.shape[0]], mont(pow(wk, c0, p))))
            cols = words_to_limbs16(prod).sum(dim=0).tolist()
            acc += sum(c << (16 * i) for i, c in enumerate(cols))
        out.append(acc % p)
    return out


# ---------------------------------------------------------------- Poseidon
def parse_records(raw: bytes):
    """64 B result records -> (hashes (n, 32) uint8, layer ids, hash ids)."""
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 64)
    meta = np.ascontiguousarray(rec[:, 32:40]).view("<u8")[:, 0]
    return rec[:, :32], meta >> np.uint64(30), meta & np.uint64(0x3FFFFFFF)


def tree_ids(height: int):
    """The (layer id, hash id) arrays a height's record stream must carry."""
    sizes = [8 ** (height - 1 - l) for l in range(height)]
    return (np.repeat(np.arange(height, dtype=np.uint64), sizes),
            np.concatenate([np.arange(n, dtype=np.uint64) for n in sizes]))


def check_tree(raw: bytes, elems: np.ndarray, height: int, spec, seed: int) -> dict:
    """A TREE_C record stream of `height` over the (11 nleaves, W) words
    `elems` against the oracle: the record count and the (layer, hash) ids,
    then up to 256 sampled leaves and 64 sampled nodes per upper layer (all
    of a smaller layer, the root included) hashed by oracle/poseidon_ref.
    `ok` is true when every check passed."""
    n = 8 ** (height - 1)
    hashes, lids, hids = parse_records(raw)
    info = {"records": len(hashes), "record_count_ok": len(hashes) == num_tree_nodes(height)}
    if not info["record_count_ok"]:
        return {**info, "ok": False}
    want_l, want_h = tree_ids(height)
    info["ids_ok"] = bool(np.array_equal(lids, want_l) and np.array_equal(hids, want_h))
    leaf_p, node_p = generate_params(spec, LEAF_ARITY + 1), generate_params(spec, 9)
    starts = np.concatenate([[0], np.cumsum([8 ** (height - 1 - l) for l in range(height)])])
    rng = np.random.default_rng(seed)

    def value(i):
        return int.from_bytes(hashes[i].tobytes(), "little")

    t0 = time.perf_counter()
    bad = []
    idx = rng.choice(n, min(n, 256), replace=False)
    for i in idx:
        col = word_ints(elems[LEAF_ARITY * i: LEAF_ARITY * (i + 1)])
        if poseidon_hash_ref(leaf_p, col) != value(i):
            bad.append((0, int(i)))
    checked, root_ok = {0: len(idx)}, False
    for l in range(1, height):
        size = 8 ** (height - 1 - l)
        sample = range(size) if size <= 64 else rng.choice(size, 64, replace=False)
        for j in sample:
            kids = [value(starts[l - 1] + 8 * j + c) for c in range(8)]
            ok = poseidon_hash_ref(node_p, kids) == value(starts[l] + j)
            if not ok:
                bad.append((l, int(j)))
            if l == height - 1:
                root_ok = ok
        checked[l] = len(sample)
    return {**info, "sampled_per_layer": checked, "sampled_mismatches": bad,
            "root_ok": root_ok, "oracle_s": time.perf_counter() - t0,
            "ok": info["ids_ok"] and not bad and root_ok}


# ---------------------------------------------------------------- pipeline
def pipeline_terms(r: int, n: int, seed: int):
    """Three coefficient batches as (row, value) terms: e_1 (scalars W^i),
    e_k for an odd k > 1 (scalars (W^k)^i) and a e_j + b e_k' (a G(W^j) +
    b G(W^k') by linearity), the odd rows k, j, k' (an odd power of W keeps
    its order, so no geometric ratio divides by zero) and a, b from the
    seed."""
    rnd = random.Random(seed)
    k, j, k2 = (2 * v + 1 for v in rnd.sample(range(1, min(n, 1 << 20) // 2), 3))
    return [((1, 1),), ((k, 1),), ((j, rnd.randrange(1, r)), (k2, rnd.randrange(1, r)))]


def pipeline_expected(spec, upoints, terms, ntt_logn: int, m: int) -> list:
    """The affine MSM each batch of `terms` must give over `upoints` tiled
    to m: for each term's row, geometric_msm_oracle of the scalars
    (W^row)^i, i < m, combined by the terms' values (linearity)."""
    r = spec.fr.p
    w = spec.fr.root_of_unity(ntt_logn)
    geo = {row: geometric_msm_oracle(spec, len(upoints), m, pow(w, row, r), upoints)
           for t in terms for row, _ in t}
    oracle = ECOracle(spec)
    return [oracle.msm([geo[row] for row, _ in t], [v for _, v in t]) for t in terms]


def coeff_batch(t, n: int, W: int, device) -> torch.Tensor:
    """(n, W) int32 canonical coefficients, zero but for the (row, value)
    terms t, made on `device`."""
    x = torch.zeros((n, W), dtype=torch.int32, device=device)
    for row, v in t:
        x[row] = torch.from_numpy(int_to_words(v, W).view(np.int32)).to(device)
    return x
