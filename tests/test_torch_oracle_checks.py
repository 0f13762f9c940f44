"""The judgements chip_smoke.py passes on results made on the card
(blaze_tpu_torch/oracle/checks.py), on the CPU.

evaluate_on_card against Python-int evaluations of a 2^10 transform, and
flagging one wrong element; check_tree accepting a height-3 TREE_C build
and refusing it with one leaf, node or root altered; parse_records and
tree_ids against the client's records and the oracle's layers;
pipeline_expected against geometric_msm_oracle and a plain MSM of the
batches' scalars; coeff_batch's rows.
"""
import random

import numpy as np
import pytest
import torch

from blaze_tpu_torch.curves import CURVES
from blaze_tpu_torch.fields import FIELDS, int_to_words
from blaze_tpu_torch.hash import LEAF_ARITY, generate_params, num_tree_nodes
from blaze_tpu_torch.ntt import FusedNTT
from blaze_tpu_torch.oracle import ECOracle
from blaze_tpu_torch.oracle.checks import (
    check_tree,
    coeff_batch,
    evaluate_on_card,
    parse_records,
    pipeline_expected,
    pipeline_terms,
    tree_ids,
    word_ints,
)
from blaze_tpu_torch.oracle.gen import host_vector, rand_words
from blaze_tpu_torch.oracle.poseidon_ref import merkle_tree_ref
from blaze_tpu_torch.pipeline import geometric_msm_oracle
from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

torch.set_num_threads(1)

FR = FIELDS["bls12_381_fr"]
LOGN = 10


@pytest.fixture(scope="module")
def transform():
    """A 2^10 bls12_381_fr transform on the CPU: (input words, output words,
    sampled indices, their Python-int evaluations)."""
    n = 1 << LOGN
    x = rand_words(FR, (n, FR.nwords), 7, "cpu")
    y = FusedNTT(FR, LOGN, device=torch.device("cpu")).ntt(x)
    ks = [0, 1, n - 1, random.Random(7).randrange(2, n - 1)]
    w, p = FR.root_of_unity(LOGN), FR.p
    vals = word_ints(x.numpy().view(np.uint32))
    want = [sum(v * pow(w, i * k, p) for i, v in enumerate(vals)) % p for k in ks]
    return x, y, ks, want


def test_evaluate_on_card_equals_python_ints_at_sampled_indices(transform):
    x, y, ks, want = transform
    got = evaluate_on_card(FR, x, FR.root_of_unity(LOGN), ks, chunk=256)
    assert got == want == word_ints(y[ks].numpy().view(np.uint32))


def test_evaluate_on_card_flags_one_wrong_element(transform):
    x, y, ks, _ = transform
    bad = y.clone()
    bad[ks[3], 0] ^= 1
    got = word_ints(bad[ks].numpy().view(np.uint32))
    want = evaluate_on_card(FR, x, FR.root_of_unity(LOGN), ks)
    assert [g == v for g, v in zip(got, want)] == [True, True, True, False]


@pytest.fixture(scope="module")
def tree():
    """A height-3 TREE_C build on the CPU client: (result_raw, the client's
    records, the (11 * 64, W) leaf words)."""
    elems = host_vector(LEAF_ARITY * 64, 9)
    cl = PoseidonClient(FR, device="cpu")
    cl.initialize(PoseidonInitializeParameters(tree_height=3))
    cl.set_data(memoryview(elems).cast("B"))
    cl.start_process()
    cl.wait_result()
    raw = cl.result_raw()
    cl.start_process()
    cl.wait_result()
    return raw, cl.result(num_tree_nodes(3)), elems


def test_check_tree_accepts_a_cpu_build(tree):
    raw, _, elems = tree
    info = check_tree(raw, elems, 3, FR, 9)
    assert info["ok"] and info["ids_ok"] and info["root_ok"]
    assert info["records"] == 73 and info["sampled_per_layer"] == {0: 64, 1: 8, 2: 1}
    assert info["sampled_mismatches"] == []


@pytest.mark.parametrize("record,mismatches", [(5, [(0, 5), (1, 0)]),
                                               (64 + 3, [(1, 3), (2, 0)]),
                                               (72, [(2, 0)])],
                         ids=["leaf", "node", "root"])
def test_check_tree_refuses_one_altered_record(tree, record, mismatches):
    """One hash altered by its low bit: its own check and its parent's fail
    (the root has none)."""
    raw, _, elems = tree
    rec = bytearray(raw)
    rec[64 * record] ^= 1
    info = check_tree(bytes(rec), elems, 3, FR, 9)
    assert not info["ok"] and info["ids_ok"]
    assert sorted(info["sampled_mismatches"]) == mismatches
    assert info["root_ok"] == (record < 64)


def test_records_carry_the_reference_ids_in_its_order(tree):
    """parse_records reads the client's records in order, its hashes the
    oracle's layers leaves first; tree_ids are their (layer, hash) ids."""
    raw, recs, elems = tree
    hashes, lids, hids = parse_records(raw)
    assert [bytes(h) for h in hashes] == [r.hash for r in recs]
    assert lids.tolist() == [r.layer_id for r in recs]
    assert hids.tolist() == [r.hash_id for r in recs]
    want_l, want_h = tree_ids(3)
    assert lids.tolist() == want_l.tolist() == [0] * 64 + [1] * 8 + [2]
    assert hids.tolist() == want_h.tolist() == [*range(64), *range(8), 0]
    vals = word_ints(elems)
    cols = [vals[i:i + LEAF_ARITY] for i in range(0, len(vals), LEAF_ARITY)]
    layers = merkle_tree_ref(generate_params(FR, LEAF_ARITY + 1), generate_params(FR, 9),
                             cols, 3)
    assert [int.from_bytes(h.tobytes(), "little") for h in hashes] == sum(layers, [])


def test_pipeline_expected_is_the_geometric_oracle():
    """At (2^8 coefficients, 16 points over 4 subgroup points): the single
    terms' expectations are geometric_msm_oracle's, and every batch's is
    the plain MSM of its scalars sum_t v_t W^(row_t i), i < 16."""
    spec = CURVES["bls12_381"]
    r, logn, m = spec.fr.p, 8, 16
    oracle = ECOracle(spec)
    rng = random.Random(3)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(4)]
    terms = pipeline_terms(r, 1 << logn, 5)
    rows = [row for t in terms for row, _ in t]
    assert len(set(rows)) == 4 and all(row % 2 for row in rows)
    got = pipeline_expected(spec, upoints, terms, logn, m)
    w = spec.fr.root_of_unity(logn)
    for t, e in zip(terms[:2], got[:2]):
        assert e == geometric_msm_oracle(spec, 4, m, pow(w, t[0][0], r), upoints)
    tiled = [upoints[i % 4] for i in range(m)]
    for t, e in zip(terms, got):
        scalars = [sum(v * pow(w, row * i, r) for row, v in t) % r for i in range(m)]
        assert e == oracle.msm(tiled, scalars)
    assert len(set(got)) == 3


def test_coeff_batch_holds_the_terms_rows():
    terms = pipeline_terms(FR.p, 1 << 6, 5)[2]
    x = coeff_batch(terms, 1 << 6, FR.nwords, "cpu")
    assert x.shape == (1 << 6, FR.nwords) and x.dtype == torch.int32
    vals = word_ints(x.numpy().view(np.uint32))
    assert {i: v for i, v in enumerate(vals) if v} == dict(terms)
    for row, v in terms:
        assert np.array_equal(x[row].numpy().view(np.uint32), int_to_words(v, FR.nwords))
