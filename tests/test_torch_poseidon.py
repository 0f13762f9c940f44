"""The port's Poseidon slice (blaze_tpu_torch.hash and PoseidonClient) against
the JAX package and the oracle, on the CPU (K10's plain version).

Same inputs, made with seeded `random` or numpy, go through blaze_tpu's
parameters, its fused Pallas permutation in interpret mode (t = 9), its
portable Poseidon (t = 12, whose interpret-mode run the JAX suite marks
slow), its tree builder and its client, and through the port.  The
constants reach the port through `params_from_reference`.  Everything is
integer arithmetic: every comparison is exact.
"""
import functools
import json
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.fields import FIELDS as REF_FIELDS
from blaze_tpu.hash import (
    Poseidon as RefPoseidon,
    TreeMode as RefTreeMode,
    generate_params as ref_generate_params,
)
from blaze_tpu.hash.kernels import PoseidonKernels as RefKernels
from blaze_tpu.runtime import (
    PoseidonClient as RefClient,
    PoseidonInitializeParameters as RefInit,
)
from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.fields.kernel_ops import PlainFieldOps, conv_cols, reduce_multiples
from blaze_tpu_torch.hash import (
    LEAF_ARITY,
    MerkleTreeBuilder,
    Poseidon,
    PoseidonKernels,
    TreeMode,
    base_layer_size,
    generate_params,
    num_tree_nodes,
    params_from_csv,
    params_from_reference,
)
from blaze_tpu_torch.hash.kernels import sum_products
from blaze_tpu_torch.oracle.poseidon_ref import (
    merkle_tree_ref,
    poseidon_hash_ref,
    poseidon_permutation_ref,
)
from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters
from blaze_tpu_torch.utils import DataError, NotReady

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

FIXDIR = Path(__file__).resolve().parent / "fixtures"
SPEC = FIELDS["bls12_381_fr"]
REF_SPEC = REF_FIELDS["bls12_381_fr"]
SCALAR_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")


def port_params(ref):
    """The JAX instance's constants carried into the port."""
    return params_from_reference(ref.spec.name, ref.t, ref.alpha, ref.r_f, ref.r_p,
                                 ref.round_constants, ref.mds)


def words_of_limbs(limbs) -> np.ndarray:
    """(..., L) 16-bit limbs -> (..., W) uint32 words."""
    return np.ascontiguousarray(np.asarray(limbs), dtype="<u2").view("<u4")


def states_lm(states, mont: bool):
    """B states of t Python ints -> the port's (t, W, B) int32 tensor and the
    JAX package's (t, L, B) limbs (Montgomery forms unless mont=False)."""
    p, r = SPEC.p, SPEC.r
    w = np.stack([np.stack([int_to_words(v * r % p if mont else v, SPEC.nwords)
                            for v in s]) for s in states])          # (B, t, W)
    port = torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0)).view(np.int32))
    limbs = w.view("<u2").astype(np.uint32)                       # (B, t, L)
    return port, jnp.asarray(np.ascontiguousarray(limbs.transpose(1, 2, 0)))


def ref_lm_words(a) -> np.ndarray:
    """The JAX package's (t, L, B) limbs -> (t, W, B) uint32 words."""
    return np.ascontiguousarray(words_of_limbs(np.moveaxis(np.asarray(a), 1, -1))
                                .transpose(0, 2, 1))


def mont_ints(lm: torch.Tensor) -> list:
    """(t, W, B) Montgomery words -> per state, the t canonical ints."""
    w = lm.numpy().view(np.uint32)
    rinv = pow(SPEC.r, -1, SPEC.p)
    return [[words_to_int(w[e, :, b]) * rinv % SPEC.p for e in range(w.shape[0])]
            for b in range(w.shape[2])]


def random_states(t, batch, seed):
    """Random canonical states, the first one p - 1 throughout."""
    rng = random.Random(seed)
    return [[SPEC.p - 1] * t] + [[rng.randrange(SPEC.p) for _ in range(t)]
                                 for _ in range(batch - 1)]


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("t", [3, 9, 12])
def test_params_match_reference_and_fixture(t):
    port, ref = generate_params(SPEC, t), ref_generate_params(REF_SPEC, t)
    assert (port.t, port.alpha, port.r_f, port.r_p) == (ref.t, ref.alpha, ref.r_f, ref.r_p)
    assert port.round_constants == ref.round_constants and port.mds == ref.mds
    assert port_params(ref) == port
    assert np.array_equal(port.rc_mont.view(np.uint32), words_of_limbs(ref.rc_mont))
    assert np.array_equal(port.mds_mont.view(np.uint32), words_of_limbs(ref.mds_mont))
    if t in (9, 12):
        fix = json.loads((FIXDIR / "poseidon_constants.json").read_text())[
            f"bls12_381_fr_t{t}"]
        assert (port.r_f, port.r_p) == (fix["r_f"], fix["r_p"])
        assert [hex(c) for c in port.round_constants] == fix["rc_hex"]
        assert [[hex(v) for v in row] for row in port.mds] == fix["mds_hex"]


def test_params_from_csv_and_reference_checks(tmp_path):
    want = generate_params(SPEC, 9)
    good = tmp_path / "good.csv"
    vals = list(want.round_constants) + [v for row in want.mds for v in row]
    good.write_text("\n".join(",".join(str(v) for v in vals[i:i + 5])
                              for i in range(0, len(vals), 5)))
    assert params_from_csv(SPEC, str(good), 9) == want
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,x\n")
    short = tmp_path / "short.csv"
    short.write_text("1,2,3\n")
    for path in (bad, short, tmp_path / "missing.csv"):
        with pytest.raises(DataError):
            params_from_csv(SPEC, str(path), 9)
    with pytest.raises(ValueError):
        params_from_reference(SPEC, 9, 5, 8, 63, want.round_constants[:-1], want.mds)
    with pytest.raises(ValueError):
        params_from_reference(SPEC, 9, 5, 8, 63, want.round_constants,
                              [[SPEC.p] * 9] * 9)


# ------------------------------------------------------- the multi-p REDC
@pytest.mark.parametrize("field", SCALAR_FIELDS)
@pytest.mark.parametrize("t", [9, 12])
def test_redc_sum_matches_python_ints(field, t):
    spec = FIELDS[field]
    p, L = spec.p, spec.nlimbs
    rng = random.Random(t)
    pairs = ([([p - 1] * t, [p - 1] * t), ([0] * t, [p - 1] * t), ([1] * t, [1] * t),
              ([p - 1] * t, [1] * t), ([p - 2] * t, [p - 1] * t)]
             + [([rng.randrange(p) for _ in range(t)], [rng.randrange(p) for _ in range(t)])
                for _ in range(11)])
    ops = PlainFieldOps(spec, lazy=False)
    rinv = pow(spec.r, -1, p)

    def limbs(vals):
        return torch.tensor(np.stack([np.frombuffer(v.to_bytes(2 * L, "little"), "<u2")
                                      for v in vals]).astype(np.int64))

    def lm(vals_per_pair):
        w = np.stack([np.stack([int_to_words(v, spec.nwords) for v in vals])
                      for vals in vals_per_pair])                   # (B, t, W)
        return torch.from_numpy(np.ascontiguousarray(w.transpose(1, 2, 0)).view(np.int32))

    via_words = sum_products(spec, lm([a for a, _ in pairs]), lm([c for _, c in pairs]))
    for b, (a, c) in enumerate(pairs):
        want = sum(x * y for x, y in zip(a, c)) * rinv % p
        cols = conv_cols(limbs(a), limbs(c), 2 * L + 1).sum(dim=0)
        got = ops.redc_sum(cols, t)
        assert sum(int(v) << (16 * i) for i, v in enumerate(got.tolist())) == want
        assert words_to_int(via_words[:, b].numpy().view(np.uint32)) == want
    assert len(reduce_multiples(spec, t)) == (t * p // spec.r + 1).bit_length()


# --------------------------------------------------------------- K10 plain
@pytest.mark.parametrize("convert_in", [False, True])
def test_plain_k10_matches_interpret_kernel_t9(convert_in):
    """K10's plain version against blaze_tpu's fused Pallas permutation in
    interpret mode (tests/test_poseidon_fused.py), t = 9, batch 3, states at
    p - 1 included (canonical inputs near p under convert_in)."""
    ref = ref_generate_params(REF_SPEC, 9)
    states = random_states(9, 3, 77)
    port_in, ref_in = states_lm(states, mont=not convert_in)
    want = RefKernels.for_params(ref, interpret=True).permute_lm(ref_in, convert_in=convert_in)
    got = PoseidonKernels.for_params(port_params(ref)).permute_lm(port_in, convert_in)
    assert np.array_equal(got.numpy().view(np.uint32), ref_lm_words(want))
    assert mont_ints(got) == [poseidon_permutation_ref(ref, s) for s in states]


def test_plain_k10_t12_matches_portable_poseidon_and_oracle():
    ref = ref_generate_params(REF_SPEC, 12)
    states = random_states(12, 3, 78)
    port_in, ref_in = states_lm(states, mont=True)
    rp = RefPoseidon(ref)
    want = rp.permute(jnp.moveaxis(ref_in, -1, 0))                 # (B, t, L)
    k = PoseidonKernels.for_params(port_params(ref))
    got = k.permute_lm(port_in)
    assert np.array_equal(got.numpy().view(np.uint32).transpose(2, 0, 1),
                          words_of_limbs(want))
    assert mont_ints(got) == [poseidon_permutation_ref(ref, s) for s in states]
    canon_in, _ = states_lm(states, mont=False)
    assert torch.equal(k.permute_lm(canon_in, convert_in=True), got)
    pm = port_in.permute(2, 0, 1).contiguous()                      # points-major
    assert torch.equal(k.permute_pm(pm[None])[0], got.permute(2, 0, 1))


def test_k10_rejects_what_it_cannot_take():
    k = PoseidonKernels.for_params(generate_params(SPEC, 9))
    for bad in (torch.zeros(9, 8, 4, dtype=torch.int64), torch.zeros(8, 8, 4, dtype=torch.int32),
                torch.zeros(9, 4, 8, dtype=torch.int32).transpose(1, 2)):
        with pytest.raises(ValueError):
            k.permute_lm(bad)
    with pytest.raises(ValueError):
        PoseidonKernels(generate_params(SPEC, 9, alpha=3))


@pytest.mark.parametrize("field,t", [("bls12_381_fq", 3), ("bn254_fr", 17)])
def test_other_widths_match_portable_poseidon(field, t):
    """A 12-word field and t = 17 (the last entry of the reference's round
    table) against blaze_tpu's portable Poseidon, word for word; alpha = 3
    raises ValueError, since blaze_tpu's S-box computes x^5 whatever alpha
    says, so there are no reference words for it."""
    spec, ref = FIELDS[field], ref_generate_params(REF_FIELDS[field], t)
    rng = random.Random(t)
    states = [[spec.p - 1] * t] + [[rng.randrange(spec.p) for _ in range(t)]
                                   for _ in range(2)]
    w = np.stack([np.stack([int_to_words(v * spec.r % spec.p, spec.nwords) for v in s])
                  for s in states])                              # (B, t, W)
    want = RefPoseidon(ref).permute(jnp.asarray(w.view("<u2").astype(np.uint32)))
    got = Poseidon(port_params(ref)).permute(torch.from_numpy(w.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), words_of_limbs(want))
    rinv = pow(spec.r, -1, spec.p)
    assert [[words_to_int(e) * rinv % spec.p for e in s] for s in got.numpy().view(np.uint32)] \
        == [poseidon_permutation_ref(ref, s) for s in states]
    with pytest.raises(ValueError):
        Poseidon(generate_params(spec, t, alpha=3))


def test_hash_matches_reference():
    """Poseidon.hash against blaze_tpu's (the node hasher of its tree, at
    the shape its height-2 close already compiled)."""
    rp = ref_client_h2()[0]._builder.node_hasher
    pp = Poseidon(port_params(rp.params))
    inputs = [random.Random(40).randrange(SPEC.p) for _ in range(8)]
    want = rp.field.to_int(rp.hash(rp.field.from_int(inputs).reshape(1, 8, -1),
                                   rp.domain_tag(0)))
    got = pp.field.to_int(pp.hash(pp.field.from_int(inputs).reshape(1, 8, -1),
                                  pp.domain_tag(0)))
    assert got == want == [poseidon_hash_ref(rp.params, inputs)]
    assert np.array_equal(pp.domain_tag(5).numpy().view("<u2"), np.asarray(rp.domain_tag(5)))


# ------------------------------------------------------------------- tree
def tree_inputs(height, mode, seed):
    """Canonical elements as 16-bit limbs (the JAX layout) and words."""
    n = base_layer_size(height) * (LEAF_ARITY if mode == TreeMode.TREE_C else 1)
    rng = random.Random(seed)
    vals = [rng.randrange(SPEC.p) for _ in range(n)]
    words = np.stack([int_to_words(v, SPEC.nwords) for v in vals])
    return vals, words.view("<u2").astype(np.uint32), words


@functools.lru_cache(maxsize=None)
def ref_client_h2():
    """blaze_tpu's PoseidonClient on the height-2 TREE_C inputs, run once:
    (client, records, result_raw bytes, result_arrays)."""
    _, limbs, _ = tree_inputs(2, TreeMode.TREE_C, 42)
    ref = RefClient(REF_SPEC)
    ref.initialize(RefInit(tree_height=2))
    ref.set_data(limbs)
    ref.start_process()
    ref.wait_result()
    recs = ref.result(num_tree_nodes(2))
    return ref, recs, ref.result_raw(), [(lid, np.asarray(a)) for lid, a in ref.result_arrays()]


@functools.lru_cache(maxsize=None)
def ref_records(height, mode):
    """The records of blaze_tpu's tree for this test's inputs: the height-2
    TREE_C client's, or its MerkleTreeBuilder's (the builder behind every
    client result), one builder instance so its jitted hashes are reused."""
    if (height, mode) == (2, TreeMode.TREE_C):
        return [(r.hash, r.layer_id, r.hash_id) for r in ref_client_h2()[1]]
    _, limbs, _ = tree_inputs(height, mode, 40 + height + 10 * int(mode))
    if mode == TreeMode.TREE_C:
        limbs = limbs.reshape(base_layer_size(height), LEAF_ARITY, -1)
    tree = ref_client_h2()[0]._builder.build(limbs, height, RefTreeMode(int(mode)))
    return [(words_of_limbs(h).tobytes(), lid, hid) for h, lid, hid in tree.records()]


@pytest.mark.parametrize("height,mode", [(2, TreeMode.TREE_C), (3, TreeMode.TREE_C),
                                         (2, TreeMode.TREE_D)])
def test_builder_matches_reference(height, mode):
    _, _, words = tree_inputs(height, mode, 40 + height + 10 * int(mode))
    nleaves = base_layer_size(height)
    shape = (nleaves, LEAF_ARITY, -1) if mode == TreeMode.TREE_C else (nleaves, -1)
    want = ref_records(height, mode)
    port = MerkleTreeBuilder(SPEC, device="cpu").build(words.reshape(shape), height, mode)
    got = [(h.tobytes(), lid, hid) for h, lid, hid in port.records()]
    assert len(port) == num_tree_nodes(height) and got == want
    assert words_to_int(port.root) == int.from_bytes(want[-1][0], "little")


# ----------------------------------------------------------------- client
def test_client_serial_lifecycle_matches_reference():
    height = 2
    vals, limbs, _ = tree_inputs(height, TreeMode.TREE_C, 40 + height)
    _, want, want_raw, want_arrays = ref_client_h2()
    raw = b"".join(v.to_bytes(SPEC.nbytes, "little") for v in vals)
    cl = PoseidonClient("bls12_381_fr", device="cpu")
    cl.initialize(PoseidonInitializeParameters(tree_height=height))
    cl.set_data(raw[: 5 * SPEC.nbytes])                      # any count per call
    cl.set_data(limbs[5:])
    cl.start_process()
    cl.wait_result()
    got = cl.result(num_tree_nodes(height))
    assert [(r.hash, r.hash_id, r.layer_id) for r in got] == \
        [(r.hash, r.hash_id, r.layer_id) for r in want]
    assert cl.result_raw() == want_raw
    arrays = cl.result_arrays()
    assert [lid for lid, _ in arrays] == [lid for lid, _ in want_arrays]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(arrays, want_arrays))
    assert words_to_int(cl.root) == int.from_bytes(want[-1].hash, "little")
    cols = [vals[i:i + LEAF_ARITY] for i in range(0, len(vals), LEAF_ARITY)]
    layers = merkle_tree_ref(generate_params(SPEC, 12), generate_params(SPEC, 9), cols, height)
    assert [int.from_bytes(r.hash, "little") for r in got] == sum(layers, [])


def test_client_streaming_feeder_and_drainer_match_reference():
    """Feed-while-hashing (tests/test_streaming.py:167-265): half the leaves
    fed first are drainable before the rest arrives; then a feeder thread
    and a drainer thread share the client.  The drained leaf records and
    the closed tree equal blaze_tpu's records (its client's builder)."""
    height = 3
    nleaves = base_layer_size(height)
    _, limbs, _ = tree_inputs(height, TreeMode.TREE_C, 40 + height)
    ref = ref_records(height, TreeMode.TREE_C)

    cl = PoseidonClient("bls12_381_fr", device="cpu")
    cl.initialize(PoseidonInitializeParameters(tree_height=height, stream_leaves=8))
    half = (nleaves // 2) * LEAF_ARITY
    cl.set_data(limbs[:half])
    drained = cl.drain_stream()
    assert len(drained) == nleaves // 2 == cl.get_last_node_id_in_ring()
    assert cl.get_num_of_pending_results() == 0
    feed_done = threading.Event()

    def feeder():
        step = LEAF_ARITY * 4
        for i in range(half, limbs.shape[0], step):
            cl.set_data(limbs[i:i + step])
            time.sleep(0.002)
        feed_done.set()

    def drainer():
        while not feed_done.is_set():
            drained.extend(cl.drain_stream())
            time.sleep(0.002)
        drained.extend(cl.drain_stream())

    threads = [threading.Thread(target=feeder), threading.Thread(target=drainer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert [r.hash_id for r in drained] == list(range(nleaves))
    assert [r.hash for r in drained] == [h for h, _, _ in ref[:nleaves]]
    cl.start_process()
    cl.wait_result()
    recs = cl.result(num_tree_nodes(height))
    assert [(r.hash, r.layer_id, r.hash_id) for r in recs] == ref


def test_client_status_getters_and_errors():
    cl = PoseidonClient(SPEC, device="cpu")
    img = cl.loaded_binary_parameters()
    assert img.primitive == "poseidon" and img.fields["leaf_arity"] == LEAF_ARITY
    with pytest.raises(NotReady):
        cl.start_process()                            # before initialize
    cl.initialize(PoseidonInitializeParameters(tree_height=2))
    assert cl.result() is None and cl.result_raw() is None and cl.root is None
    _, limbs, _ = tree_inputs(2, TreeMode.TREE_C, 42)
    cl.set_data(limbs[:-1])
    with pytest.raises(NotReady):
        cl.start_process()                            # one element short
    with pytest.raises(DataError):
        cl.set_data(b"\x00" * (SPEC.nbytes + 1))
    with pytest.raises(DataError):
        cl.set_data(np.zeros((2, 3), np.uint32))
    cl.set_data(limbs[-1:])
    assert cl.get_last_element_sent_to_ring() == limbs.shape[0]
    assert cl.get_last_node_id_in_ring() == 0 and cl.get_num_of_pending_results() == 0
    cl.start_process()
    cl.wait_result()
    api = cl.get_api()
    assert set(api) == {"elements_staged", "pending_results", "device_residency", "stage_s",
                        "streamed_leaves", "pending_tasks", "timings", "health"}
    assert api["device_residency"] and api["pending_tasks"] == 1
    assert cl.get_num_of_pending_results() == cl.get_last_node_id_in_ring() == 9
    with pytest.raises(NotReady):
        cl.result(expected_count=10)
    cl.start_process()                                # resident columns, no new upload
    assert len(cl.result(expected_count=9)) == 9
