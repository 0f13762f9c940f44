"""The benchmark's runners, the counterparts of bench.py's bench_msm,
bench_ntt, bench_poseidon, bench_pipeline and main.

    python -m blaze_tpu_torch.bench

prints one JSON line shaped like bench.py's (the first record's metric,
value, unit and vs_baseline, the others under `extra`):

    {"metric": "bls12_381_msm_2^24", "value": N, "unit": "points/sec",
     "vs_baseline": 1.0, "ms": ..., "median_ms": ..., "sol_fraction": ...,
     "imad_fraction": ..., "oracle": "exact", "device": "<name>, <limit>",
     "extra": {"ntt_2^27": {...}, "poseidon_2^24_leaves": {...},
               "pipeline_ntt2^27_msm2^24": {...}}}

Every record is checked exactly against an oracle, or its runner fails; a
failed runner is named under `errors` and the run exits 1.  `ms` is the
best of the timed runs, `median_ms` their median, by the host clock around
work that ends in a synchronise of the card.  `sol_fraction` and
`imad_fraction` divide the work the algorithm needs (bench/profile.py
msm_work, ntt_work, poseidon_work, pipeline_work) by the best time and by
the card's SOL_TABLE row, which is first held against the card.

Settings, bench.py's environment names (defaults on the card / on the CPU):
  BLZ_BENCH_DEVICE         cuda; cpu runs the kernels' plain versions
  BLZ_BENCH_LOGN           MSM size, 24 / 8
  BLZ_BENCH_CURVE          the MSM's curve, bls12_381
  BLZ_BENCH_ITERS          timed runs per record, 3
  BLZ_BENCH_NTT_LOGN       27 / 10 (the pipeline's NTT size too)
  BLZ_BENCH_POSEIDON_LOGL  tree leaves 2^logl (a multiple of 3), 24 / 6
  BLZ_BENCH_PIPELINE       1 / 0: run the pipeline by default
  BLZ_BENCH_ONLY           csv of msm,ntt,poseidon,pipeline
  BLZ_BENCH_RECORD         1: write the values to BENCH_TORCH_PREV.json
vs_baseline is the value over the one BENCH_TORCH_PREV.json holds for the
same card and metric, else 1.0.
"""
from __future__ import annotations

import gc
import json
import os
import random
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..curves import CURVES, Curve
from ..fields import FIELDS, Field, int_to_words
from ..fields.kernel_ops import words_to_limbs16
from ..hash import LEAF_ARITY, generate_params, num_tree_nodes
from ..msm import MSM, points_to_resident
from ..msm.pippenger import default_window_bits
from ..ntt import FusedNTT
from ..oracle import ECOracle
from ..oracle.gen import (
    LARGE_PARAM,
    host_vector,
    points_to_affine_words,
    rand_words,
    subgroup_msm_instance,
)
from ..oracle.poseidon_ref import poseidon_hash_ref
from ..pipeline import ProofPipeline, geometric_msm_oracle
from ..runtime import PoseidonClient, PoseidonInitializeParameters
from .profile import (
    SOL_TABLE,
    check_card,
    msm_work,
    ntt_work,
    pipeline_work,
    poseidon_work,
    smi,
    speed_of_light,
    wall_s,
)

PREV_PATH = Path(__file__).resolve().parents[2] / "BENCH_TORCH_PREV.json"
RUNNERS = ("msm", "ntt", "poseidon", "pipeline")
DEFAULTS = {   # (logn, ntt_logn, poseidon_logl, pipeline on) per device
    "cuda": (24, 27, 24, "1"),
    "cpu": (8, 10, 6, "0"),
}
NTT_FIELD = "bls12_381_fr"


def _record(metric: str, unit: str, count: float, times: list, work: tuple, sol,
            device, **info) -> dict:
    """A runner's record: `count` items per best run as the value, the best
    and median ms, and the work's attainment against `sol`."""
    best = min(times)
    rec = {"metric": metric, "value": count / best, "unit": unit, "ms": best * 1e3,
           "median_ms": statistics.median(times) * 1e3,
           "sol_fraction": work[0] / best / sol.hbm_bytes_per_s,
           "imad_fraction": work[1] / best / sol.imad_per_s,
           "oracle": "exact", "iters": len(times), **info}
    if _on_card(device):
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return rec


def affine_of(res: torch.Tensor, spec):
    """(3, W) projective Montgomery words -> affine (x, y) ints (None for
    the identity): the R of X, Y and Z cancels in X / Z."""
    X, Y, Z = (int.from_bytes(res[i].cpu().numpy().tobytes(), "little") for i in range(3))
    p = spec.fq.p
    if Z % p == 0:
        return None
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _indexed(device) -> torch.device:
    """`device` with the card's index ("cuda" -> cuda:<current>): the plans
    compare devices by equality."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _reset_peak(device) -> None:
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats()


# --------------------------------------------------------------------- MSM
def bench_msm(logn: int, curve_name: str, iters: int, sol, device="cuda",
              seed: int = 123) -> dict:
    """MSM.__call__ on 2^logn resident points and scalars (the headline,
    bench.py:10): 256 order-r subgroup points tiled, distinct scalars
    uniform in [0, r), the result against class_sum_expected.  One warm-up
    call on a card, then `iters` timed calls."""
    spec = CURVES[curve_name]
    cv = Curve(spec)
    n = 1 << logn
    t0 = time.perf_counter()
    upoints, scal, want = subgroup_msm_instance(spec, n, seed)
    gen_s = time.perf_counter() - t0
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(device)
    resident = points_to_resident(cv, pts).repeat(1, n // LARGE_PARAM)
    scalars = torch.from_numpy(scal.view(np.int32)).to(device).t().contiguous()
    del scal
    msm = MSM(cv)
    c = min(msm.config.window_bits, default_window_bits(n))
    out = [msm(resident, scalars) if _on_card(device) else None]    # warm-up on a card
    _reset_peak(device)
    times = wall_s(lambda: out.__setitem__(0, msm(resident, scalars)), iters, device)
    got = affine_of(out[0], spec)
    if got != want:
        raise AssertionError(f"msm 2^{logn}: {got} differs from the oracle {want}")
    return _record(f"{curve_name}_msm_2^{logn}", "points/sec", n, times,
                   msm_work(spec, n, c), sol, device, n=n,
                   chunk_log2=msm.config.chunk_log2, window_bits=c, input_gen_s=gen_s)


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


def bench_ntt(logn: int, iters: int, sol, device="cuda", seed: int = 7) -> dict:
    """FusedNTT.ntt of 2^logn canonical bls12_381_fr words already on the
    device (the reference's 2^27, ntt_data.rs:65); only the transform is
    timed.  The output must come back to the input through intt and equal
    the input polynomial evaluated at W^k at four indices (Python ints of
    sums of K1 products, no NTT kernel)."""
    spec = FIELDS[NTT_FIELD]
    n = 1 << logn
    device = _indexed(device)
    t0 = time.perf_counter()
    plan = FusedNTT(spec, logn, device=device)
    plan_s = time.perf_counter() - t0
    x = rand_words(spec, (n, spec.nwords), seed, device)
    out = [plan.ntt(x)] if _on_card(device) else []                 # warm-up on a card
    _reset_peak(device)

    def run():
        out.clear()                  # one output buffer at a time (4 GiB at 2^27)
        out.append(plan.ntt(x))

    times = wall_s(run, iters, device)
    y = out.pop()
    rec = _record(f"ntt_2^{logn}", "elems/sec", n, times, ntt_work(spec, logn), sol,
                  device, n=n, field=NTT_FIELD, parts=plan.parts, plan_s=plan_s)
    rng = random.Random(seed)
    ks = [0, 1, n - 1, rng.randrange(2, n - 1)]
    got = word_ints(y[ks].cpu().numpy().view(np.uint32))
    roundtrip = bool(torch.equal(plan.intt(y), x))
    del y
    want = evaluate_on_card(spec, x, spec.root_of_unity(logn), ks)
    if not roundtrip or got != want:
        raise AssertionError(f"ntt 2^{logn}: roundtrip {roundtrip}, evaluations at {ks} "
                             f"{'match' if got == want else 'differ'}")
    return rec


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


def bench_poseidon(logl: int, iters: int, sol, device="cuda", seed: int = 9) -> dict:
    """A TREE_C Merkle tree over 2^logl leaves of 11 bls12_381_fr elements
    through PoseidonClient (5.5 GiB of host words at logl 24, PERF.md's
    height-9 sub-tree of Filecoin's TreeC): set_data once, one warm-up
    build (which stages the columns on the device), then `iters` timed
    start_process -> wait_result builds on the resident columns; the
    records of the last (result_raw) against the oracle (check_tree)."""
    if logl % 3:
        raise ValueError(f"8-ary tree base must be a power of 8 (logl={logl})")
    spec = FIELDS[NTT_FIELD]
    height = 1 + logl // 3
    nleaves = 1 << logl
    t0 = time.perf_counter()
    elems = host_vector(LEAF_ARITY * nleaves, seed)          # canonical, < 2^254 < p
    gen_s = time.perf_counter() - t0
    cl = PoseidonClient(spec, device=device)
    cl.initialize(PoseidonInitializeParameters(tree_height=height))
    t0 = time.perf_counter()
    cl.set_data(memoryview(elems).cast("B"))
    cl.start_process()                                      # warm-up, stages the columns
    cl.wait_result()
    first_s = time.perf_counter() - t0
    _reset_peak(device)
    times = wall_s(lambda: (cl.start_process(), cl.wait_result()), iters, device)
    rec = _record(f"poseidon_2^{logl}_leaves", "leaves/sec", nleaves, times,
                  poseidon_work(spec, height, generate_params(spec, LEAF_ARITY + 1),
                                generate_params(spec, 9)),
                  sol, device, height=height, input_gen_s=gen_s,
                  set_data_and_first_build_s=first_s, via="client")
    t0 = time.perf_counter()
    raw = cl.result_raw()
    rec["result_raw_s"] = time.perf_counter() - t0
    check = check_tree(raw, elems, height, spec, seed)
    if not check["ok"]:
        raise AssertionError(f"poseidon 2^{logl}: {check}")
    rec["sampled_per_layer"] = check["sampled_per_layer"]
    return rec


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


def bench_pipeline(ntt_logn: int, msm_logn: int, iters: int, sol, device="cuda",
                   seed: int = 11) -> dict:
    """ProofPipeline.run_batches on BLS12-381 (BASELINE config 5): max(iters,
    2) + 1 batches of 2^ntt_logn coefficients made on the device, cycling
    through pipeline_terms' three distinct batches, against 256 order-r
    subgroup points tiled to 2^msm_logn; every result against its geometric
    oracle.  The wall per batch is (last - first stamp) / (batches - 1), as
    bench.py:300-303 counts it; `ms` and `median_ms` are the least and the
    median gap between stamps."""
    spec = CURVES["bls12_381"]
    cv, r = Curve(spec), spec.fr.p
    n, m = 1 << ntt_logn, 1 << msm_logn
    U = min(LARGE_PARAM, m)
    t0 = time.perf_counter()
    rng = random.Random(seed)
    upoints = [ECOracle(spec).random_subgroup_point(rng) for _ in range(U)]
    terms = pipeline_terms(r, n, seed)
    expected = pipeline_expected(spec, upoints, terms, ntt_logn, m)
    oracle_s = time.perf_counter() - t0

    pipe = ProofPipeline(cv, ntt_logn, msm_logn, device=device)
    dev = pipe.ctx.device
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    resident = points_to_resident(cv, pts).repeat(1, m // U)
    nb = max(iters, 2) + 1
    _reset_peak(dev)
    stamps, outs = [], []
    t0 = time.perf_counter()
    batches = (coeff_batch(terms[i % 3], n, spec.fr.nwords, dev) for i in range(nb))
    for out in pipe.run_batches(batches, resident):
        stamps.append(time.perf_counter() - t0)
        outs.append(out)
    got = [affine_of(o, spec) for o in outs]
    bad = [i for i, g in enumerate(got) if g != expected[i % 3]]
    if bad or len(set(got[:3])) != 3:
        raise AssertionError(f"pipeline: batches {bad} differ from their oracle, "
                             f"distinct {len(set(got[:3])) == 3}")
    per_batch = (stamps[-1] - stamps[0]) / (nb - 1)
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    c = min(pipe.msm.config.window_bits, default_window_bits(m))
    rec = _record(f"pipeline_ntt2^{ntt_logn}_msm2^{msm_logn}", "proofs/sec", 1, gaps,
                  pipeline_work(spec, ntt_logn, msm_logn, c), sol, dev, batches=nb,
                  unique_points=U, oracle_s=oracle_s, mean_ms=per_batch * 1e3)
    rec["value"] = 1 / per_batch
    return rec


# -------------------------------------------------------------------- main
def _history() -> dict:
    """{card name: {metric: value}} from BENCH_TORCH_PREV.json, or {}."""
    if not PREV_PATH.exists():
        return {}
    return json.loads(PREV_PATH.read_text())


def main() -> int:
    env = os.environ
    device = env.get("BLZ_BENCH_DEVICE", "cuda")
    if device not in DEFAULTS:
        print(f"blaze_tpu_torch.bench: BLZ_BENCH_DEVICE={device!r}, want cuda or cpu",
              file=sys.stderr)
        return 2
    if device == "cuda":
        if not torch.cuda.is_available():
            print("blaze_tpu_torch.bench: no CUDA device (BLZ_BENCH_DEVICE=cpu runs the "
                  "plain versions)", file=sys.stderr)
            return 1
        kind = torch.cuda.get_device_name(0)
        sol = speed_of_light(kind)
        check_card(sol)
        label = smi("name,power.limit")
        _build.build_all()                   # one nvcc per source, all at once
    else:
        kind, sol, label = "cpu", SOL_TABLE["cpu"], "cpu"
    d_logn, d_ntt, d_logl, d_pipe = DEFAULTS[device]
    logn = int(env.get("BLZ_BENCH_LOGN", d_logn))
    curve_name = env.get("BLZ_BENCH_CURVE", "bls12_381")
    iters = int(env.get("BLZ_BENCH_ITERS", "3"))
    ntt_logn = int(env.get("BLZ_BENCH_NTT_LOGN", d_ntt))
    logl = int(env.get("BLZ_BENCH_POSEIDON_LOGL", d_logl))
    default_set = "msm,ntt,poseidon" + (",pipeline" if env.get("BLZ_BENCH_PIPELINE", d_pipe)
                                        == "1" else "")
    only = [s for s in env.get("BLZ_BENCH_ONLY", default_set).split(",") if s]
    unknown = sorted(set(only) - set(RUNNERS))
    if unknown:
        print(f"blaze_tpu_torch.bench: unknown runners {unknown}, want {RUNNERS}",
              file=sys.stderr)
        return 2

    hist = _history()
    prev = hist.get(kind, {})
    runners = {
        "msm": lambda: bench_msm(logn, curve_name, iters, sol, device),
        "ntt": lambda: bench_ntt(ntt_logn, iters, sol, device),
        "poseidon": lambda: bench_poseidon(logl, iters, sol, device),
        "pipeline": lambda: bench_pipeline(ntt_logn, logn, iters, sol, device),
    }
    recs, errors = [], {}
    for name in RUNNERS:
        if name not in only:
            continue
        try:
            rec = runners[name]()
        except Exception as e:       # a failed runner must not hide the others
            traceback.print_exc()
            errors[name] = f"{type(e).__name__}: {e}"
        else:
            rec["device"] = label
            rec["vs_baseline"] = rec["value"] / prev[rec["metric"]] if prev.get(
                rec["metric"]) else 1.0
            recs.append(rec)
        finally:
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()

    if recs:
        head = recs[0]
        out = {"metric": head["metric"], "value": head["value"], "unit": head["unit"],
               "vs_baseline": head["vs_baseline"],
               "extra": {r["metric"]: {k: v for k, v in r.items() if k != "metric"}
                         for r in recs[1:]}}
        for k, v in head.items():
            out.setdefault(k, v)
    else:
        out = {"metric": "error", "value": 0, "unit": "none", "vs_baseline": 0,
               "device": label}
    if errors:
        out["errors"] = errors
    print(json.dumps(out), flush=True)
    if env.get("BLZ_BENCH_RECORD") == "1" and recs:
        hist[kind] = {**prev, **{r["metric"]: r["value"] for r in recs}}
        PREV_PATH.write_text(json.dumps(hist, indent=1) + "\n")
    return 1 if errors or not recs else 0
