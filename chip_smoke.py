#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (blaze_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card (nvidia-smi name and power limit, CUDA, capability),
   then the kernels built from csrc/ with nvcc (seconds, registers, stack,
   spills) and the local-memory loads and stores (LDL, STL) in the EC, NTT
   and Poseidon kernels' SASS, with the opcode mix of K2, K3, K4, K7 (at
   K = 512) and K10 (cuobjdump);
2. kernel parity: K1-K6 against their plain PyTorch versions on the card,
   exact, on BN254, BLS12-377 and BLS12-381 at small shapes (K2 signed and
   unsigned) and at ragged shapes: K2 and K4 at lane counts B = 1, 33,
   1000 (C = 1; K4 also over rows that hold identities), K3 at the same
   lane counts (identities as either operand, p = q), K5 at B = 1, 33,
   1000 (k 15), K6 at Wn = 1, 2, 20 (c 13) and, on the 12-word curves, at
   Wn = 128 (c 2, past 48 KB of shared memory); then at the main path's
   shapes for BLS12-381 with each kernel's time (CUDA events), its plain
   version's time and its bound: K2 at a 2^19 chunk (C 512, B 16384) and a
   streamed 2^18 chunk (B 8192), K3 at a lane-prefix round (B 16384) and
   at the window sums' accumulation (B 16), K4's five rounds at a 2^19
   chunk, K5 at (B 16, k 16) and K6 at (Wn 16, c 16) and (Wn 20, c 13);
   K3, K5 and K6 beside their chain bound (the products on the team's
   critical path times one product's latency, timed on one thread:
   blz_product_chain);
3. main path, streamed client: MSMClient(MSMInit("bls12_381")) over 2^20
   points in the reference's order initialize -> start_process -> four
   set_data chunks of wire bytes -> result();
4. main path, single-chunk client: 2^19 points, set_data -> start_process
   -> wait_result -> result();
4b. the headline shape (bench.py:10): 2^24 points resident, set_data once
   -> start_process -> wait_result -> result(), 32 chunks of 2^19, their
   window sums accumulated on K3 and folded on K6 (the fold's seconds
   printed).  Phases 3, 4 and 4b each launch K6 exactly once.  With
   --parent DIR the
   same instance then runs in five pairs of fresh child processes on the
   same card, one from another tree of the package (the parent commit
   unpacked under build/) and one from this tree, the side that goes
   first alternating; all must give the same result bytes (a parent tree
   whose fold ran on the Field prints it as field_fold_s).  After it, one warm
   2^19 single-chunk MSM runs under torch.profiler (device busy time,
   idle share).
   Phases 3, 4 and 4b use 256 points of the order-r subgroup tiled and
   distinct scalars drawn uniformly from [0, r); the expected value is the
   oracle MSM of the 256 points with each point's coefficient sum mod r,
   and the result bytes must match it after z-normalisation.
5. NTT kernel parity: K7-K9 against their plain versions, exact, on
   bn254_fr, bls12_377_fr and bls12_381_fr at small shapes (K7 through
   (K, B) rows in and out of place, a strided input into a transposed
   output and two levels of 2^10-point plans, ragged lane counts among
   them; K8 with 2 and 3 operands on word-major batches and on element
   rows of 1, 33 and 1000 elements, in place; K9 with the twiddle row in
   low and high bits of the element's row); then at the 2^27 transform's
   shapes on bls12_381_fr with times and bounds (K7 at each of its three
   levels, K9 at depths 0 and 1), each compared with its plain version on
   a cut (2^11 lanes, 2^20 rows: the plain versions hold ~2 KB of int64
   per element), and K8 at the 2^16 plan's call (2^16 element rows times
   the plan's element-order twiddles, in place) and with 3 operands; then
   one whole 2^27 and one 2^16 transform under torch.profiler: the time
   split into K7, K8, K9 and any other device operation, their counts
   (K7 x3 and K9 x2 at 2^27, K7 x2 and K8 x1 at 2^16, nothing else, or
   the phase fails), and the peak memory;
6. main path, NTT client at 2^27 on bls12_381_fr: three random vectors,
   each transformed serially and then in the reference's double-buffered
   order (integration_ntt.rs:103-136); each pipelined output must equal
   the serial one, come back to its input through the inverse client
   byte for byte, and equal the input polynomial evaluated at W^k at 11
   indices (Field.powers, K1 products and integer sums on the card, no
   NTT kernel); a sparse input must match host sums at 64 indices;
7. NTT client at 2^16 (the K8 twiddle fallback) and 2^20 (K9, both
   branches) against an independent host NTT in Python ints, with inverse
   roundtrips, and every committed tests/fixtures/ntt_* golden pair.
7b. the proof pipeline (ProofPipeline on BLS12-381) at ntt_logn 27 and
   msm_logn 24: 256 order-r subgroup points tiled to 2^24 and resident on
   the card; three coefficient batches made on the card from --seed (e_1,
   e_k for an odd k, a e_j + b e_k'), run serially (one batch at a time,
   synchronised, launch counts per batch: K7 x3, K9 x2, K2 x32, K6 x1, no
   K8) and then through run_batches (the next batch's NTT on a side stream
   while the host queues this batch's MSM); the results must be distinct,
   equal byte for byte between the two runs and equal each batch's
   geometric oracle (pipeline.geometric_msm_oracle, by linearity for the
   third).  It prints the serial and pipelined walls per batch, proofs/s,
   one batch's NTT and scalars alone (CUDA events), the NTT stream's and
   the MSM's device time, each stream's operations and the card's idle
   share around the middle batch of a third run (DeviceContext.profile),
   and the peak device memory;
7c. (run before 7b) the sharded paths (dist/) on the card, NCCL, every
   mesh of one rank (make_mesh's group of one): K7 and K9 at batched maps (FusedNTT's
   ntt_batch levels, B transforms per launch) against their plain
   versions, whole, on the three scalar fields, then at the 2^27
   four-step's maps (K7 at each level of the 2^13 column and 2^14 row
   sub-plans, K9 at their twiddles and at the inter-pass twiddle) with
   times and bounds, each held against its plain version on a cut;
   DistributedMSM at 2^24 on BLS12-381 (256 subgroup points tiled,
   distinct full-width scalars) equal to the single-card MSM.__call__
   (run in turns with it: sharded, single, single, sharded) and the
   oracle; DistributedNTT at 2^27 on bls12_381_fr (logn1 13)
   whose spectral_to_natural equals FusedNTT.ntt word for word and
   whose intt comes back to the input (launches K7 x4, K9 x3, no K8; one
   transform under torch.profiler: K7 x4, K9 x3 and nothing else, where
   the profiler records device events at all);
   ProofPipeline(mesh={dp: 1, sp: 1}).run_dist at (2^27, 2^24) with
   full-width scalars against its geometric oracle.  Each prints wall
   seconds, device milliseconds (CUDA events), launches per kernel and
   peak memory; launch counts are zeroed before each run;
8. Poseidon kernel parity: K10 against its (dense) plain version, exact,
   on the three scalar fields (t = 9 and 12, with and without convert_in,
   B = 1 and 1000, inputs near p; the sparse schedule, and on bls12_381_fr
   the dense rounds of an instance whose MDS has a singular lower-right
   block), the multi-p REDC twin against the plain redc_sum on edge inputs
   (T = t (p-1)^2 ...); then over the 12-word base fields (t = 3 and 17)
   and at t = 17 on bn254_fr, the widest state of the reference's round
   table; then at the height-9 tree's shapes on bls12_381_fr
   (t = 12 at 2^24 states with convert_in, t = 9 at 2^21) with times, the
   bounds of the sparse and of the dense work, each held against its
   plain version on a cut of 2^10 states;
9. PoseidonClient("bls12_381_fr") at height 4, the reference's contract
   (512 leaves, 5,632 wire elements, 585 nodes): initialize -> set_data ->
   start_process -> wait_result -> result(expected_count=585) and
   result_raw, every node against the oracle; then TREE_D at height 4;
10. the full-size tree, height 9: 2^24 leaves of 11 elements (5.5 GiB of
   wire bytes from --seed), set_data once, two builds (the second on the
   resident columns) with result_raw, the record count and ids, 256
   sampled leaves and 64 sampled nodes per upper layer (all of smaller
   layers, the root included) against the oracle, the second build equal
   to the first, peak device memory;
11. streaming at height 7 (2^18 leaves, stream_leaves 2^14): a feeder
   thread calls set_data while a drainer thread calls drain_stream; leaf
   records must arrive before the last feed and the closed tree must
   equal a staged build of the same elements.
   Launch counts are zeroed just before each client run of phases 3, 4,
   4b, 6, 7, 9, 10 and 11, each serial batch of 7b and each run of 7c,
   and read just after; every kernel of the run's path must have launched (K10 nine
   times per height-9 build; K2 once and K4 five times per 2^19 chunk at
   2^24; K6 once per MSM).
12. the seconds each phase took, then the kernels line (K1-K10): launches
   in those runs, parity error, times, bounds, threads per lane, and K3's,
   K5's and K6's chain bound.  A kernel's `ms` is CUDA events around
   repeated launches queued behind a spin of the card, so a kernel shorter
   than its launch from Python (K1, K3, K8) is not timed at the host's
   pace.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi prints them.  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
IMAD_PER_CLK_PER_SM = 64           # 32-bit integer multiply-add, CC 9.0

# launch-counter name -> (source, the TPU kernel's pallas_call it replaces);
# in PERF.md's table these are K1-K10 in this order
KERNELS = {
    "mont_mul": ("blaze_tpu_torch/csrc/montmul.cu", "blaze_tpu/fields/mxu.py:250"),
    "scan_mixed": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:248"),
    "ec_add": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:563"),
    "reduce_cols": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:343"),
    "dbl_n": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:508"),
    "fold_horner": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:444"),
    "ntt_base": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:102"),
    "mul_lm": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:168"),
    "twiddle_mul": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:252"),
    "poseidon_perm": ("blaze_tpu_torch/csrc/poseidon_kernels.cu",
                      "blaze_tpu/hash/kernels.py:207"),
}
NTT_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")


def threads_per_lane(name: str) -> int:
    """Threads that compute one lane of a kernel, as its built library
    reports it (blz_threads_per_lane of the kernel's source)."""
    from blaze_tpu_torch import _build

    return _build.threads_per_lane(Path(KERNELS[name][0]).stem, name)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def random_scalars(spec, n: int, seed: int):
    """n distinct scalars uniform in [0, r) as (n, Ls) uint32 16-bit limbs,
    drawn with seeded numpy by rejection of 255-bit words >= r."""
    import numpy as np

    fr = spec.fr
    nw = fr.nwords
    r_words = np.frombuffer(fr.p.to_bytes(4 * nw, "little"), dtype="<u4")
    top_mask = (1 << (fr.bits - 32 * (nw - 1))) - 1
    rng = np.random.default_rng(seed)
    out = np.empty((0, nw), dtype=np.uint32)
    while out.shape[0] < n:
        w = rng.integers(0, 1 << 32, size=(n, nw), dtype=np.uint64).astype(np.uint32)
        w[:, -1] &= top_mask
        diff = (w != r_words)[:, ::-1]                     # from the top word
        first = nw - 1 - np.argmax(diff, axis=1)
        lt = diff.any(axis=1) & (w[np.arange(n), first] < r_words[first])
        out = np.concatenate([out, w[lt]])[:n]
    # distinct: the top 64 bits already are, but for a chance of ~n^2 2^-64
    top = np.ascontiguousarray(out[:, -2:]).view(np.uint64)[:, 0]
    if np.unique(top).shape[0] != n and np.unique(out, axis=0).shape[0] != n:
        raise AssertionError("scalars not distinct")
    return np.ascontiguousarray(out).view("<u2").astype(np.uint32).reshape(n, -1)


def tiled_arrays(spec, n: int, seed: int, expected: bool = True):
    """256 oracle points of the order-r subgroup (to be tiled: point i is
    upoints[i % 256], n a multiple of 256), n distinct random scalars as
    (n, Ls) uint32 limbs, and the expected affine MSM: the oracle MSM of the
    256 points with each one's coefficient sum mod r (summed per 16-bit
    limb in numpy)."""
    import numpy as np

    from blaze_tpu_torch.oracle import ECOracle

    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(256)]
    scal = random_scalars(spec, n, seed)
    want = None
    if expected:
        sums = scal.reshape(n // 256, 256, -1).sum(axis=0, dtype=np.int64)   # (256, Ls)
        coeffs = [sum(int(v) << (16 * i) for i, v in enumerate(row)) % spec.fr.p
                  for row in sums]
        want = oracle.msm(upoints, coeffs)
    return upoints, scal, want


def tiled_instance(spec, n: int, seed: int, expected: bool = True):
    """Wire bytes of n points (tiled_arrays' 256 points tiled) and n
    distinct random scalars, and the expected affine MSM."""
    import numpy as np

    from blaze_tpu_torch.curves import encode_affine_points, encode_scalars
    from blaze_tpu_torch.oracle.gen import points_to_affine_words

    upoints, scal, want = tiled_arrays(spec, n, seed, expected)
    pts = points_to_affine_words(spec, upoints)[np.arange(n) % 256]
    return encode_affine_points(pts, spec), encode_scalars(scal, spec), want


def affine_of(raw: bytes, spec):
    from blaze_tpu_torch.curves import decode_projective_result
    from blaze_tpu_torch.fields import words_to_int

    X, Y, Z = (words_to_int(v) for v in decode_projective_result(raw, spec))
    p = spec.fq.p
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


# ----------------------------------------------------------------- timing
SPIN_CYCLES = 40_000_000      # ~20 ms of the card's clock


def cuda_ms(fn, reps: int) -> float:
    """Mean time of fn's work on the card over `reps` calls, warm: CUDA
    events around the calls, queued behind a spin of the card so that the
    host has queued them all before the first runs (else a kernel shorter
    than its launch from Python is timed at the host's pace)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dev_us(e) -> float:
    """A profiler event's own device time (us), across torch versions."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs()
    return int(d.max()) if d.numel() else 0


# ------------------------------------------------------------ phase 1
KERNEL_NAME = re.compile(r"([a-z_]+_kernel)ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d))?")


def kernel_key(mangled: str):
    """'scan_mixed_kernel<12>s' for a mangled kernel name (s: signed),
    'ntt_base_kernel<8,9>' for two int parameters, or None for other
    functions."""
    m = KERNEL_NAME.search(mangled)
    if not m:
        return None
    args = m.group(2) + ("," + m.group(3) if m.group(3) else "")
    return f"{m.group(1)}<{args}>" + ("s" if m.group(4) == "1" else "")


def ptxas_summary(logs: dict) -> dict:
    """'kernel<W>[s]' -> [registers, stack bytes, spill-store bytes]
    from nvcc's -Xptxas -v output (device functions: registers None)."""
    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            if "Function properties for" in line:
                name = kernel_key(line)
                if name:
                    out[name] = [None, 0, 0]
            elif name and "stack frame" in line:
                f = line.split()
                out[name][1:] = [int(f[0]), int(f[4])]
            elif name and "Used" in line and "registers" in line:
                out[name][0] = int(line.split("Used")[1].split()[0])
    return out


def sass_summary(libs, mix_of=("scan_mixed_kernel<12>", "ec_add_kernel<12>",
                              "reduce_cols_kernel<12>", "ntt_base_kernel<8,9>",
                              "poseidon_perm_kernel<8>")):
    """From cuobjdump -sass of the built libraries: 'kernel<W>[s]' ->
    [LDL, STL], the local-memory loads and stores in its code, and for the
    kernels in `mix_of` the static count of each opcode (the most frequent
    12).  None without cuobjdump."""
    import collections
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = "\n".join(subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                                    text=True, check=True).stdout for lib in libs)
    local, mix, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_key(line)
            if name:
                local[name] = [0, 0]
                if name in mix_of:
                    mix[name] = collections.Counter()
        elif name:
            local[name][0] += " LDL" in line
            local[name][1] += " STL" in line
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and name in mix:
                mix[name][m.group(1)] += 1
    return {"ldl_stl": local,
            "opcodes": {k: dict(v.most_common(12)) | {"total": sum(v.values())}
                        for k, v in mix.items()}}


def phase_device():
    import torch

    from blaze_tpu_torch import _build

    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    build_s = _build.build_all()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0)),
          "sms": props.multi_processor_count, "max_sm_clock_mhz": clock_mhz,
          "build_s": build_s, "ptxas": ptxas_summary(_build.BUILD_LOG),
          "sass": sass_summary([_build._lib_path(n) for n in ("ec_kernels", "ntt_kernels",
                                                              "poseidon_kernels")])})
    return card, props.multi_processor_count * IMAD_PER_CLK_PER_SM * clock_mhz * 1e6


# ------------------------------------------------------------ phase 2
def curve_inputs(spec, C: int, B: int, seed: int, device):
    """(C, 2W, B) affine Montgomery rows of oracle points (16 distinct,
    repeated) and a random sign row."""
    import torch

    from blaze_tpu_torch.curves import Curve
    from blaze_tpu_torch.oracle import ECOracle

    cv = Curve(spec)
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    pts = [oracle.random_point(rng) for _ in range(16)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=device),
                       cv.fq.from_int([y for _, y in pts], device=device)], dim=1)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, 16, (C * B,), generator=g).to(device)
    rows = aff[idx].reshape(C, B, -1).permute(0, 2, 1).contiguous()
    sgn = torch.randint(0, 2, (C, 1, B), generator=g, dtype=torch.int32).to(device)
    return cv, aff, rows, torch.cat([rows, sgn], dim=1).contiguous()


def kernel_cases(spec, C: int, B: int, seed: int, device, main: bool):
    """(key, kernel, kernel call, plain call, shape) for K1-K6 on one curve's
    inputs; at the main shapes also K2 at the streamed chunk's lanes and
    K4's later rounds (keys scan_mixed_streamed, reduce_cols_r2..r5)."""
    import torch

    from blaze_tpu_torch.curves.kernels import ECKernels
    from blaze_tpu_torch.fields.montmul import mont_mul, mont_mul_plain

    k = ECKernels.for_curve(spec)
    cv, aff, rows, rows_s = curve_inputs(spec, C, B, seed, device)
    emitted, _ = k.scan_mixed(rows)              # lazy points for K3-K6
    p, q = emitted[C // 2].contiguous(), emitted[-1].contiguous()
    W = spec.fq.nwords
    m = (1 << 19) if main else 512
    a = aff[torch.arange(m, device=device) % aff.shape[0]].reshape(-1, W)[:m].contiguous()
    b = a.flip(0).contiguous()
    red_rows = emitted[: C // 2, :, : B // 2].contiguous()
    ws = emitted[-1, :, :16].contiguous()
    ws20 = emitted[-1, :, 16:36].contiguous()
    pts = p[:, :16].contiguous() if main else p
    cases = [
        ("mont_mul", lambda: mont_mul(spec.fq, a, b), lambda: mont_mul_plain(spec.fq, a, b),
         {"M": m}),
        ("scan_mixed", lambda: k.scan_mixed(rows), lambda: k.scan_mixed_plain(rows),
         {"C": C, "B": B}),
        ("ec_add", lambda: k.add(p, q), lambda: k.add_plain(p, q), {"B": B}),
        ("reduce_cols", lambda: k.reduce_cols(red_rows), lambda: k.reduce_cols_plain(red_rows),
         {"C": C // 2, "B": B // 2}),
        ("dbl_n", lambda: k.dbl_n(pts, 16), lambda: k.dbl_n_plain(pts, 16),
         {"B": pts.shape[1], "k": 16}),
        ("fold_horner", lambda: k.fold_horner(ws, 16), lambda: k.fold_horner_plain(ws, 16),
         {"Wn": 16, "c": 16}),
    ]
    cases = [(c[0], *c) for c in cases]
    if not main:
        cases.append(("scan_mixed", "scan_mixed", lambda: k.scan_mixed(rows_s),
                      lambda: k.scan_mixed_plain(rows_s), {"C": C, "B": B, "signed": 1}))
        return cases
    # a streamed 2^18 chunk scans the same C rows over half the lanes; the
    # bucket sum's later reduce_cols rounds at a 2^19 chunk (G = 16 windows)
    half = rows[:, :, : B // 2].contiguous()
    cases.append(("scan_mixed_streamed", "scan_mixed", lambda: k.scan_mixed(half),
                  lambda: k.scan_mixed_plain(half), {"C": C, "B": B // 2}))
    cases.append(("fold_horner_c13", "fold_horner", lambda: k.fold_horner(ws20, 13),
                  lambda: k.fold_horner_plain(ws20, 13), {"Wn": 20, "c": 13}))
    # K3 at the accumulation of the chunks' window sums: one lane per window
    pw, qw = p[:, :16].contiguous(), q[:, :16].contiguous()
    cases.append(("ec_add_windows", "ec_add", lambda: k.add(pw, qw),
                  lambda: k.add_plain(pw, qw), {"B": 16}))
    for r, (Cr, Br) in enumerate(((16, 512), (4, 128), (2, 64), (4, 16)), start=2):
        rr = emitted[:Cr, :, :Br].contiguous()
        cases.append((f"reduce_cols_r{r}", "reduce_cols", lambda rr=rr: k.reduce_cols(rr),
                      lambda rr=rr: k.reduce_cols_plain(rr), {"C": Cr, "B": Br}))
    return cases


def ragged_cases(spec, seed: int, device):
    """(key, kernel, kernel call, plain call, shape) for K2 (unsigned and
    signed) and K4 at ragged lane counts B = 1, 33, 1000: one row (C = 1),
    and for K4 also four rows that hold identities, as the bucket sum's
    padding does; K3 at the same lane counts, identities as either operand
    and p = q; K5 at the same lane counts (k 15, identity lanes among
    them); K6 at Wn = 1, 2 and 20 (c 13) with identity windows, and on
    12-word curves at Wn = 128 (c 2), whose window sums take K6 past 48 KB
    of shared memory."""
    from blaze_tpu_torch.curves import Curve
    from blaze_tpu_torch.curves.kernels import ECKernels

    k = ECKernels.for_curve(spec)
    ident = Curve(spec).identity(device=device).reshape(-1, 1)
    cases = []
    for B in (1, 33, 1000):
        _, _, rows, rows_s = curve_inputs(spec, 4, B, seed + B, device)
        emitted, _ = k.scan_mixed(rows)
        emitted[1, :, ::3] = ident
        emitted[:, :, -1:] = ident[None]
        for C in (1, 4):
            r1, r1s, e = (x[:C].contiguous() for x in (rows, rows_s, emitted))
            if C == 1:
                cases += [
                    ("scan_mixed", "scan_mixed", lambda r=r1: k.scan_mixed(r),
                     lambda r=r1: k.scan_mixed_plain(r), {"C": C, "B": B}),
                    ("scan_mixed", "scan_mixed", lambda r=r1s: k.scan_mixed(r),
                     lambda r=r1s: k.scan_mixed_plain(r), {"C": C, "B": B, "signed": 1}),
                ]
            cases.append(("reduce_cols", "reduce_cols", lambda e=e: k.reduce_cols(e),
                          lambda e=e: k.reduce_cols_plain(e),
                          {"C": C, "B": B, "identities": int(C > 1)}))
        p, q = emitted[1].clone(), emitted[2].clone()
        q[:, 1::4] = p[:, 1::4]                           # p = q
        for a, b, what in ((p, q, "p+q"), (q, p, "q+p"), (p, p, "p+p")):
            cases.append(("ec_add", "ec_add", lambda a=a, b=b: k.add(a, b),
                          lambda a=a, b=b: k.add_plain(a, b), {"B": B, "operands": what}))
        pts = emitted[1].contiguous()
        cases.append(("dbl_n", "dbl_n", lambda x=pts: k.dbl_n(x, 15),
                      lambda x=pts: k.dbl_n_plain(x, 15), {"B": B, "k": 15}))
    _, _, rows, _ = curve_inputs(spec, 2, 128, seed, device)
    wins = k.scan_mixed(rows)[0][1]                              # (3W, 128) lazy points
    wins[:, 1::5] = ident
    shapes = [(1, 13), (2, 13), (20, 13)] + ([(128, 2)] if spec.fq.nwords == 12 else [])
    for Wn, c in shapes:
        ws = wins[:, :Wn].contiguous()
        cases.append(("fold_horner", "fold_horner", lambda ws=ws, c=c: k.fold_horner(ws, c),
                      lambda ws=ws, c=c: k.fold_horner_plain(ws, c), {"Wn": Wn, "c": c}))
    return cases


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def output_err(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(as_tuple(got), as_tuple(want)))


def poseidon_imads(shape: dict, W: int, sparse: bool) -> int:
    """32-bit multiply-adds of one Poseidon state: 3 full products per
    S-box (r_f t + r_p of them) and t more with convert_in; a dense mix is
    t^2 unreduced products (2W^2 each) and t row REDCs (2W^2 + W); a sparse
    partial round's mix is t unreduced products, one REDC and t - 1 full
    products."""
    t, r_f, r_p = shape["t"], shape["r_f"], shape["r_p"]
    full, unreduced, redc = 4 * W * W + W, 2 * W * W, 2 * W * W + W
    n = (3 * (r_f * t + r_p) + t * shape["convert_in"]) * full
    n += r_f * t * (t * unreduced + redc)
    if sparse:
        return n + r_p * (t * unreduced + redc + (t - 1) * full)
    return n + r_p * t * (t * unreduced + redc)


def work_bound_ms(name: str, shape: dict, W: int, imad_rate: float):
    """Least time for the same work: the larger of the bytes it must move
    (inputs read once, outputs written once) over HBM bandwidth and its
    32-bit multiply-adds over the card's IMAD rate.  A W-word Montgomery
    product needs 2W^2 full 32x32->64 products (2 IMADs each) and W low
    products (4W^2 + W IMADs); alg 8 has 13 products, alg 7 has 14.  A
    K-point NTT needs (K/2) log2 K - (K - 1) products per lane: a butterfly
    whose twiddle is W^0 needs none (all of stage 0, K/2^(s+1) of stage s;
    K7 skips them).  K9 needs two per element, K8 one per operand past the
    first."""
    per_mul = 4 * W * W + W
    pt = 3 * W * 4                                # bytes of one projective point
    el = W * 4                                    # bytes of one field element
    if name == "poseidon_perm":
        muls = shape["B"] * poseidon_imads(shape, W, shape["sparse"]) / per_mul
        nbytes = 2 * shape["t"] * shape["B"] * el
    elif name == "ntt_base":
        K, N = shape["K"], shape["lanes"]
        muls = ((K // 2) * (K.bit_length() - 1) - (K - 1)) * N
        nbytes = 2 * K * N * el + K * el
    elif name == "twiddle_mul":
        A, J, S, B = shape["A"], shape["J"], shape["S"], shape["B"]
        muls = 2 * A * J * S * B
        nbytes = 2 * A * J * S * B * el + A * (J + S) * el
    elif name == "mul_lm":
        M, N, k = shape["M"], shape["N"], shape["operands"]
        muls, nbytes = (k - 1) * M * N, (k + 1) * M * N * el
    elif name == "mont_mul":
        muls, nbytes = shape["M"], 3 * shape["M"] * W * 4
    elif name == "scan_mixed":
        C, B = shape["C"], shape["B"]
        muls = 13 * C * B
        nbytes = C * B * (2 * W * 4 + 4 * shape.get("signed", 0)) + C * B * pt + B * pt
    elif name == "ec_add":
        muls, nbytes = 14 * shape["B"], 3 * shape["B"] * pt
    elif name == "reduce_cols":
        C, B = shape["C"], shape["B"]
        muls, nbytes = 14 * C * B, (C + 1) * B * pt
    elif name == "dbl_n":
        muls, nbytes = 14 * shape["k"] * shape["B"], 2 * shape["B"] * pt
    else:  # fold_horner
        muls = 14 * (shape["Wn"] - 1) * (shape["c"] + 1)
        nbytes = (shape["Wn"] + 1) * pt
    t_ops = muls * per_mul / imad_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


CHAIN_PRODUCTS = 3     # dependent products per group op on the team (ec_team.cuh)


def product_latency_us(spec, device, n: int = 4096) -> float:
    """One lazy product's latency (us) on one thread of the card: n
    dependent carry-chain products in one launch (blz_product_chain, CUDA
    events), its words first held against the plain products at n = 16."""
    from blaze_tpu_torch.curves.kernels import ECKernels

    k = ECKernels.for_curve(spec)
    x, y = rand_words(spec.fq, (2, spec.fq.nwords), 7, device).unbind(0)
    if max_abs_err(k.product_chain(x, y, 16), k.product_chain_plain(x, y, 16)):
        raise AssertionError("blz_product_chain differs from the plain products")
    return cuda_ms(lambda: k.product_chain(x, y, n), 3) * 1e3 / n


CHAINED = ("ec_add", "dbl_n", "fold_horner")


def chain_bound_ms(name: str, shape: dict, latency_us: float) -> float:
    """K3's, K5's and K6's chain bound: the products on the team's critical
    path (CHAIN_PRODUCTS per group op; K3 one group op per lane, K5 one
    per doubling, K6 one per step) times one product's latency."""
    if name == "ec_add":
        ops = 1
    elif name == "dbl_n":
        ops = shape["k"]
    else:
        ops = max((shape["Wn"] - 1) * (shape["c"] + 1), 1)
    return CHAIN_PRODUCTS * ops * latency_us / 1e3


def phase_parity(imad_rate: float, device):
    import torch

    from blaze_tpu_torch.curves import CURVES

    errs = {name: 0 for name in KERNELS}
    for curve in ("bn254", "bls12_377", "bls12_381"):
        spec = CURVES[curve]
        checked, ragged = {}, []
        small = kernel_cases(spec, 8, 1024, 1, device, main=False)
        for i, (key, name, kern, plain, shape) in enumerate(
                small + ragged_cases(spec, 1, device)):
            e = output_err(kern(), plain())
            errs[name] = max(errs[name], e)
            if i < len(small):
                checked[key + ("_signed" if shape.get("signed") else "")] = e
            else:
                ragged.append({"kernel": name, **shape, "max_abs_err": e})
        torch.cuda.synchronize()
        emit({"phase": "parity", "curve": curve, "shape": "small (C=8, B=1024)",
              "max_abs_err": checked, "ragged": ragged})
        if any(checked.values()) or any(c["max_abs_err"] for c in ragged):
            raise AssertionError(f"{curve}: kernel differs from its plain version")

    # the main path's shapes: BLS12-381 at a 2^19 chunk (16 windows of
    # c = 16, R = 1024 lanes, C = 512 rows; the bucket sum's first
    # reduce_cols pass is C = 256 rows of G * R2 = 8192 lanes)
    spec = CURVES["bls12_381"]
    W = spec.fq.nwords
    latency_us = product_latency_us(spec, device)
    emit({"phase": "product_latency", "curve": "bls12_381", "W": W, "us": latency_us})
    timing = {}
    for key, name, kern, plain, shape in kernel_cases(spec, 512, 16384, 2, device, main=True):
        reps = 3 if shape.get("C", 0) >= 256 else 20
        ms = cuda_ms(kern, reps)
        want, plain_ms = once_ms(plain)
        e = output_err(kern(), want)
        errs[name] = max(errs[name], e)
        bound, bound_by = work_bound_ms(name, shape, W, imad_rate)
        timing[key] = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": e,
                       "threads_per_lane": threads_per_lane(name)}
        if name in CHAINED:
            timing[key]["chain_bound_ms"] = chain_bound_ms(name, shape, latency_us)
        del want
        torch.cuda.empty_cache()
    emit({"phase": "parity", "curve": "bls12_381", "shape": "main path", "kernels": timing})
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("kernel differs from its plain version at the main shapes")
    return errs, timing


# --------------------------------------------------------- phases 3 and 4
def run_streamed(n: int, chunks: int, seed: int, device=None):
    """Phase 3: initialize -> start_process -> set_data chunks -> result()."""
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    praw, sraw, expected = tiled_instance(spec, n, seed)
    client = MSMClient(MSMInit(curve="bls12_381"), device=device)
    client.initialize(MSMParams(nof_elements=n))
    step = n // chunks
    pb, sb = spec.point_bytes, spec.scalar_bytes
    t0 = time.perf_counter()
    client.start_process()
    for lo in range(0, n, step):
        client.set_data(MSMInput(scalars=sraw[lo * sb:(lo + step) * sb],
                                 points=praw[lo * pb:(lo + step) * pb]))
    res = client.result()
    total = time.perf_counter() - t0
    ok = affine_of(res.result, spec) == expected
    return ok, {"n": n, "chunks": chunks, "set_data_s": client.timings.set_data_s,
                "start_to_result_s": total, "points_per_s": n / total}


def run_single(n: int, seed: int, device=None):
    """Phase 4: set_data(points + scalars) -> start_process -> wait -> result."""
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    praw, sraw, expected = tiled_instance(spec, n, seed)
    client = MSMClient(MSMInit(curve="bls12_381"), device=device)
    client.initialize(MSMParams(nof_elements=n))
    t0 = time.perf_counter()
    client.set_data(MSMInput(scalars=sraw, points=praw))
    t1 = time.perf_counter()
    client.start_process()
    client.wait_result()
    t2 = time.perf_counter()
    res = client.result()
    ok = affine_of(res.result, spec) == expected
    return ok, {"n": n, "set_data_s": t1 - t0, "start_to_wait_s": t2 - t1,
                "points_per_s": n / (t2 - t1)}


def phase_main_path(seed: int):
    from blaze_tpu_torch import _build

    launches = {}
    for phase, run in [("streamed", lambda: run_streamed(1 << 20, 4, seed)),
                       ("single_chunk", lambda: run_single(1 << 19, seed + 1))]:
        _build.reset_launches()
        ok, info = run()
        counts = dict(_build.LAUNCHES)
        emit({"phase": phase, "oracle": "match" if ok else "MISMATCH", **info,
              "launches": counts})
        if not ok:
            raise AssertionError(f"{phase}: result differs from the oracle")
        check_msm_launches(phase, counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def run_resident(n: int, seed: int, device=None, inputs: Path | None = None):
    """The headline shape (bench.py:10, bls12_381_msm_2^24): set_data once
    with every point and scalar, start_process -> wait_result -> result(),
    n / 2^19 chunks on the card and the window fold (`finalize`, timed).  The
    instance is tiled_instance(n, seed), or the one save_instance wrote to
    `inputs`.  Returns (ok, info)."""
    import torch

    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    t0 = time.perf_counter()
    if inputs is None:
        praw, sraw, expected = tiled_instance(spec, n, seed)
    else:
        praw, sraw = ((inputs / f).read_bytes() for f in ("points.bin", "scalars.bin"))
        expected = tuple(json.loads((inputs / "expected.json").read_text()))
    gen_s = time.perf_counter() - t0
    client = MSMClient(MSMInit(curve="bls12_381"), device=device)
    client.initialize(MSMParams(nof_elements=n))
    fold = {}
    engine_finalize = client.engine.finalize

    def finalize(wsums, c):
        fold["enqueued"] = time.perf_counter()       # the host has queued every chunk
        torch.cuda.synchronize()
        t = fold["done"] = time.perf_counter()       # and the card has run them
        out = engine_finalize(wsums, c)
        torch.cuda.synchronize()
        fold["s"] = time.perf_counter() - t
        return out

    client.engine.finalize = finalize
    t0 = time.perf_counter()
    client.set_data(MSMInput(scalars=sraw, points=praw))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    client.start_process()
    client.wait_result()
    t2 = time.perf_counter()
    raw = client.result().result
    ok = affine_of(raw, spec) == expected
    return ok, {"n": n, "chunks": -(-n // (1 << client.engine.config.chunk_log2)),
                "input_gen_s": gen_s, "set_data_s": t1 - t0, "start_to_wait_s": t2 - t1,
                "points_per_s": n / (t2 - t1), "fold_s": fold.get("s"),
                "chunks_queued_s": fold["enqueued"] - t1, "chunks_done_s": fold["done"] - t1,
                "result_sha256": hashlib.sha256(raw).hexdigest()}


def profile_single_chunk(seed: int, n: int = 1 << 19) -> dict:
    """One warm single-chunk MSM (start_process -> wait_result) under
    torch.profiler: the wall time, the device's busy time (the sum of the
    device events' times: kernels and copies on one stream) and idle share,
    their count, and the ones that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    praw, sraw, _ = tiled_instance(spec, n, seed, expected=False)
    client = MSMClient(MSMInit(curve="bls12_381"))
    client.initialize(MSMParams(nof_elements=n))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    client.start_process()
    client.wait_result()
    client.result()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.start_process()
        client.wait_result()
        wall = time.perf_counter() - t0
    client.result()

    # the device's own events (kernels, copies): the aten ops above them
    # report the same time again as theirs
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    info = {"n": n, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms or None,
            "idle_share": (1 - busy_ms / (wall * 1e3)) if busy_ms else None,
            "device_ops": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3} for e in top]}
    emit({"phase": "msm_2^19_profile", **info})
    return info


MSM_NEEDS = ("mont_mul", "scan_mixed", "ec_add", "reduce_cols", "dbl_n", "fold_horner")


def check_msm_launches(phase: str, counts: dict) -> None:
    """Every MSM kernel launched, and K6 exactly once: one fold per MSM."""
    check_launches(phase, counts, MSM_NEEDS)
    if counts["fold_horner"] != 1:
        raise AssertionError(f"{phase}: {counts['fold_horner']} K6 launches, want 1")


def phase_msm_2e24(seed: int, n: int = 1 << 24) -> dict:
    """MSM 2^24 resident through MSMClient against the oracle; returns the
    launch counts (every chunk runs K2 once and K4 five times)."""
    from blaze_tpu_torch import _build

    _build.reset_launches()
    ok, info = run_resident(n, seed + 2)
    counts = dict(_build.LAUNCHES)
    emit({"phase": "msm_2^24_resident", "oracle": "match" if ok else "MISMATCH", **info,
          "launches": counts})
    if not ok:
        raise AssertionError("msm 2^24: result differs from the oracle")
    check_msm_launches("msm_2^24", counts)
    chunks = info["chunks"]
    if counts["scan_mixed"] != chunks or counts["reduce_cols"] != 5 * chunks:
        raise AssertionError(f"msm 2^24: {counts['scan_mixed']} K2 and "
                             f"{counts['reduce_cols']} K4 launches for {chunks} chunks")
    return counts


def save_instance(d: Path, n: int, seed: int) -> Path:
    """tiled_instance(n, seed) on BLS12-381 as files under `d`, for
    run_resident(inputs=d)."""
    from blaze_tpu_torch.curves import CURVES

    praw, sraw, expected = tiled_instance(CURVES["bls12_381"], n, seed)
    d.mkdir(parents=True, exist_ok=True)
    (d / "points.bin").write_bytes(praw)
    (d / "scalars.bin").write_bytes(sraw)
    (d / "expected.json").write_text(json.dumps(list(expected)))
    return d


def resident_in_child(tree: Path, n: int, inputs: Path) -> dict:
    """run_resident on the instance in `inputs`, in a fresh child process
    that imports the blaze_tpu_torch of `tree` (this checkout, or another
    tree of the package such as the parent commit unpacked under build/; its
    kernels are built there first).  Raises unless the child's package came
    from `tree` and its result matched the oracle; returns the child's line
    (with its launch counts)."""
    tree = tree.resolve()
    code = (
        "import importlib.util, json, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(tree)!r})\n"
        "from blaze_tpu_torch import _build\n"
        f"if Path(_build.__file__).resolve().parents[1] != Path({str(tree)!r}):\n"
        "    raise SystemExit(f'imported {_build.__file__}, not the tree asked for')\n"
        "b = _build.build_all(('montmul', 'ec_kernels'))\n"
        f"spec = importlib.util.spec_from_file_location('smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)\n"
        "_build.reset_launches()\n"
        f"ok, info = cs.run_resident({n}, 0, inputs=Path({str(inputs.resolve())!r}))\n"
        "print(json.dumps({'tree': str(Path(_build.__file__).resolve().parents[1]),\n"
        "                  'build_s': b, 'oracle': ok, **info,\n"
        "                  'launches': dict(_build.LAUNCHES)}))\n"
    )
    # -P: no working directory on the child's path, so only `tree` provides
    # the package
    out = subprocess.run([sys.executable, "-P", "-c", code], cwd=tree, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"msm 2^24 from {tree} failed:\n{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    if Path(line["tree"]) != tree or not line["oracle"]:
        raise AssertionError(f"msm 2^24 from {tree}: tree {line['tree']}, "
                             f"oracle {line['oracle']}")
    return line


COMPARE_PAIRS = 5


def phase_msm_2e24_compare(parent: Path, seed: int, n: int = 1 << 24) -> dict:
    """The end-to-end comparison at the headline shape: the 2^24 phase's
    instance, made once, run from the parent's tree and from this one, each
    run in a fresh child process on the same card, COMPARE_PAIRS pairs with
    the side that goes first alternating (parent, change, change, parent,
    ...).  Every run must match the oracle and give the same result bytes.
    Prints one line per run and one with both sides' lists."""
    import shutil

    inputs = save_instance(ROOT / "build" / "msm_2e24_instance", n, seed + 2)
    runs = []
    try:
        for i in range(2 * COMPARE_PAIRS):
            side = "parent" if (i % 4) in (0, 3) else "change"
            line = resident_in_child(parent if side == "parent" else ROOT, n, inputs)
            emit({"phase": "msm_2^24_compare", "run": i, "side": side, **line})
            runs.append((side, line))
    finally:
        shutil.rmtree(inputs, ignore_errors=True)
    if len({line["result_sha256"] for _, line in runs}) != 1:
        raise AssertionError("msm 2^24: parent and change give different result bytes")
    # a parent tree whose fold ran on the Field names its time field_fold_s
    for _, line in runs:
        line.setdefault("fold_s", line.get("field_fold_s"))
    summary = {side: {key: [line[key] for s, line in runs if s == side]
                      for key in ("points_per_s", "start_to_wait_s", "set_data_s",
                                  "chunks_done_s", "fold_s")}
               for side in ("parent", "change")}
    emit({"phase": "msm_2^24_compare_summary", "order": [s for s, _ in runs], **summary})
    return summary


# ------------------------------------------------------------ phase 5
def rand_words(spec, shape, seed: int, device):
    """int32 words of canonical values below 2^(bits-1) < p, the word axis
    at dim 1 (element buffers (N, W), lanes-major (R, W, N))."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                      dtype=torch.int32, device=device)
    top = spec.bits - 1 - 32 * (spec.nwords - 1)
    x.select(1, spec.nwords - 1).bitwise_and_((1 << top) - 1)
    return x


def ntt_kernel_cases(spec, seed: int, device):
    """(name, kernel call, plain call, shape) for K7-K9 at small shapes,
    every branch: K7 through (K, B) rows out of and in place (K = 128 and
    256 end on a short pass after full ones), a strided
    input into a transposed output, and two levels of 2^10-point plans
    (level 0 of parts 3, 4, 3 out of place into reversed lane digits; level
    1 of 3, 3, 4 in place), ragged lane counts among them; K8 with 2 and 3
    operands on word-major batches and on element rows (M = 1, 33, 1000;
    three operands in place); K9 with the row's v bits low and high (and
    in place)."""
    import torch

    from blaze_tpu_torch.ntt import NTTKernels
    from blaze_tpu_torch.ntt.fused import plan_levels
    from blaze_tpu_torch.ntt.kernels import TileMap

    k = NTTKernels.for_spec(spec)
    W = spec.nwords
    rows = TileMap.rows
    layouts = [(2, 300, "rows", 600, rows(300), 600, rows(300), False),
               (8, 1000, "rows", 8000, rows(1000), 8000, rows(1000), False),
               (128, 21, "rows", 128 * 21, rows(21), 128 * 21, rows(21), False),
               (256, 11, "rows", 256 * 11, rows(11), 256 * 11, rows(11), True),
               (512, 37, "rows", 512 * 37, rows(37), 512 * 37, rows(37), False),
               (512, 64, "rows", 512 * 64, rows(64), 512 * 64, rows(64), True),
               (64, 45, "strided_to_transposed", 64 * 48, TileMap.lanes_at(48), 64 * 45,
                TileMap.lanes_at(1, 6), False)]
    for name, parts, d in (("level0_of_343", [3, 4, 3], 0), ("level1_of_334", [3, 3, 4], 1)):
        lv = plan_levels(parts)[d]
        layouts.append((1 << lv.a, lv.lanes, name, 1024, lv.xmap, 1024, lv.omap,
                        lv.xmap == lv.omap))
    cases = []
    for i, (K, B, name, nx, xmap, no, omap, in_place) in enumerate(layouts):
        x = rand_words(spec, (nx, W), seed + i, device)
        pack = rand_words(spec, (K, W), seed + 10 + i, device)

        def fresh(x=x, no=no, in_place=in_place):
            return x.clone() if in_place else torch.zeros((no, W), dtype=torch.int32,
                                                          device=device)

        def kern(x=x, pack=pack, B=B, xmap=xmap, omap=omap, fresh=fresh, in_place=in_place):
            out = fresh()
            return k.ntt_base(out if in_place else x, pack, B, xmap, out=out, omap=omap)

        cases.append(("ntt_base", kern,
                      lambda x=x, pack=pack, B=B, xmap=xmap, omap=omap, fresh=fresh:
                      k.ntt_base_plain(x, pack, B, xmap, out=fresh(), omap=omap),
                      {"K": K, "lanes": B, "layout": name, "in_place": int(in_place)}))
    a, b, c = (rand_words(spec, (4, W, 1000), seed + 20 + i, device) for i in range(3))
    cases.append(("mul_lm", lambda: k.mul_lm(a, b), lambda: k.mul_lm_plain(a, b),
                  {"M": 4, "N": 1000, "operands": 2}))
    cases.append(("mul_lm", lambda: k.mul_lm(a, b, c), lambda: k.mul_lm_plain(a, b, c),
                  {"M": 4, "N": 1000, "operands": 3}))
    for M in (1, 33, 1000):                 # element rows, the plan's form
        a, b, c = (rand_words(spec, (M, W, 1), seed + 60 + M + i, device) for i in range(3))
        cases.append(("mul_lm", lambda a=a, b=b: k.mul_lm(a, b),
                      lambda a=a, b=b: k.mul_lm_plain(a, b), {"M": M, "N": 1, "operands": 2}))
        cases.append(("mul_lm", lambda a=a, b=b, c=c: (lambda o: k.mul_lm(o, b, c, out=o))(
                          a.clone()),
                      lambda a=a, b=b, c=c: k.mul_lm_plain(a, b, c),
                      {"M": M, "N": 1, "operands": 3, "in_place": 1}))
    for i, (A, J, S, B) in enumerate(((16, 8, 32, 1), (16, 4, 8, 16))):
        y = rand_words(spec, (A * J * S * B, W), seed + 30 + i, device)
        t1 = rand_words(spec, (A * J, W), seed + 40 + i, device).reshape(A, J, W)
        t2 = rand_words(spec, (A * S, W), seed + 50 + i, device).reshape(A, S, W)
        la, lb, lc = A.bit_length() - 1, B.bit_length() - 1, (J * S).bit_length() - 1
        # v in the row's low bits (a level-0 twiddle) or above j and b
        vs, f = (0, ((la + lb, lc, 0),)) if i == 0 else (lb + lc, ((lb, lc, 0),))
        shape = {"A": A, "J": J, "S": S, "B": B, "vshift": vs}
        cases.append(("twiddle_mul", lambda y=y, t1=t1, t2=t2, vs=vs, f=f:
                      k.twiddle_mul(y, t1, t2, vs, f),
                      lambda y=y, t1=t1, t2=t2, vs=vs, f=f: k.twiddle_mul_plain(y, t1, t2, vs, f),
                      shape))
        cases.append(("twiddle_mul", lambda y=y, t1=t1, t2=t2, vs=vs, f=f:
                      (lambda o: k.twiddle_mul(o, t1, t2, vs, f, out=o))(y.clone()),
                      lambda y=y, t1=t1, t2=t2, vs=vs, f=f: k.twiddle_mul_plain(y, t1, t2, vs, f),
                      {**shape, "in_place": 1}))
    return cases


def ntt_main_timing(plan, imad_rate: float, seed: int, device):
    """K7-K9 at the shapes of the 2^27 bls12_381_fr transform (`plan`): K7
    at each of its three levels (level 0 reads the input's rows and writes
    the plan's buffer, levels 1 and 2 update it in place), K9 at depths 0
    and 1, K8 at the 2^16 plan's twiddle call (two operands in place, its
    only main-path use) and with three operands: time, bound, and the
    kernel's output on a cut (K7 2^11 lanes, K9 2^20 rows) against the
    plain version on the same cut."""
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT

    spec = FIELDS["bls12_381_fr"]
    W = spec.nwords
    k = plan.kern
    timing = {}

    def measure(key, name, shape, kern, check, plain, cut, plain_shape, reps):
        """kern: the timed launch; check: the kernel's output on the plain
        version's inputs; cut: the rows both cover."""
        ms = cuda_ms(kern, reps)
        want, plain_ms = once_ms(plain)
        e = max_abs_err(cut(check()), cut(want))
        bound, bound_by = work_bound_ms(name, shape, W, imad_rate)
        timing[key] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                       "plain_shape": plain_shape, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": e}
        del want
        torch.cuda.empty_cache()

    n, lane_cut, row_cut = plan.n, 1 << 11, 1 << 20
    x = rand_words(spec, (n, W), seed, device)
    buf = rand_words(spec, (n, W), seed + 1, device)
    for d, lv in enumerate(plan.levels):
        key = "ntt_base" if d == 0 else f"ntt_base_level{d}"
        pack, K = plan._packs[(lv.a, False)], 1 << lv.a
        src = x if d == 0 else buf.clone()

        def launch(src, lv=lv, pack=pack):
            return k.ntt_base(src, pack, lv.lanes, lv.xmap, out=buf if d == 0 else src,
                              omap=lv.omap)

        measure(key, "ntt_base", {"K": K, "lanes": lv.lanes, "level": d},
                lambda launch=launch: launch(x if d == 0 else buf),
                lambda launch=launch, src=src: launch(src),
                lambda lv=lv, pack=pack, src=src: k.ntt_base_plain(
                    src, pack, lane_cut, lv.xmap, out=torch.zeros_like(buf), omap=lv.omap),
                lambda o, rows=lv.omap.offsets(K, lane_cut, device).reshape(-1): o[rows],
                {"K": K, "lanes": lane_cut}, 5)
        del src
    del x
    for d, lv in enumerate(plan.levels[:-1]):
        key = "twiddle_mul" if d == 0 else f"twiddle_mul_depth{d}"
        t1, t2 = plan._tabs[(d, False)]
        J, S = t1.shape[1], t2.shape[1]
        y = buf[:row_cut].clone()               # rows 0.. of the buffer: the same v, j
        measure(key, "twiddle_mul", {"A": 1 << lv.a, "J": J, "S": S,
                                     "B": 1 << lv.vshift, "depth": d},
                lambda lv=lv, t1=t1, t2=t2: k.twiddle_mul(buf, t1, t2, lv.vshift, lv.fields,
                                                          out=buf),
                lambda y=y, lv=lv, t1=t1, t2=t2: k.twiddle_mul(y, t1, t2, lv.vshift, lv.fields),
                lambda y=y, lv=lv, t1=t1, t2=t2: k.twiddle_mul_plain(y, t1, t2, lv.vshift,
                                                                     lv.fields),
                lambda o: o, {"rows": row_cut}, 5)
    del buf
    # K8 at the 2^16 plan's call: its buffer times the plan's element-order
    # twiddles, in place; and with three operands into a new buffer
    small = FusedNTT(spec, 16, device=device)
    rows = small._twiddle_rows(0, False).view(small.n, W, 1)
    y, z = (rand_words(spec, (small.n, W, 1), seed + 3 + i, device) for i in range(2))
    ybuf = y.clone()
    for key, ops in (("mul_lm", (rows,)), ("mul_lm_3_operands", (rows, z))):
        shape = {"M": small.n, "N": 1, "operands": 1 + len(ops)}
        timed = ((lambda: k.mul_lm(ybuf, rows, out=ybuf)) if len(ops) == 1 else
                 (lambda ops=ops: k.mul_lm(y, *ops)))
        measure(key, "mul_lm", shape, timed, lambda ops=ops: k.mul_lm(y, *ops),
                lambda ops=ops: k.mul_lm_plain(y, *ops), lambda o: o, shape, 50)
    return timing


SPLIT_KERNELS = ("ntt_base", "mul_lm", "twiddle_mul")
SPLIT = (*SPLIT_KERNELS, "nccl", "other")


def device_split(fn) -> dict:
    """fn() once under torch.profiler: the device time and count of K7
    (ntt_base_kernel), K8 (mul_lm_*kernel), K9 (twiddle_mul_kernel), NCCL's
    collectives (kernels named nccl*) and every other device operation (a
    copy, a fill, a gather, listed in other_ops), and the wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    split = {k: [0, 0.0] for k in SPLIT}
    others = []
    # the device's own events: the aten ops above them report the same time
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or dev_us(e) <= 0:
            continue
        key = next((k for k in SPLIT_KERNELS if k + "_" in e.key and "kernel" in e.key),
                   "nccl" if "nccl" in e.key.lower() else "other")
        split[key][0] += e.count
        split[key][1] += dev_us(e) / 1e3
        if key == "other":
            others.append({"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3})
    return {"wall_ms": wall * 1e3, "device_ms": sum(v[1] for v in split.values()),
            **{f"{k}_launches": v[0] for k, v in split.items()},
            **{f"{k}_ms": v[1] for k, v in split.items()}, "other_ops": others}


def ntt_transform_split(plan, seed: int, device, want: dict) -> dict:
    """One warm transform (plan.ntt) timed whole with CUDA events and traced
    under torch.profiler (device_split), and the transform's peak memory.
    `want`: the launches of each kernel; any other count, or any other
    device operation, raises."""
    import torch

    W = plan.spec.nwords
    x = rand_words(plan.spec, (plan.n, W), seed, device)
    ms = cuda_ms(lambda: plan.ntt(x), 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    split = device_split(lambda: plan.ntt(x))
    peak = torch.cuda.max_memory_allocated()
    del x
    info = {"n": plan.n, "parts": plan.parts, "transform_ms": ms, **split,
            "input_gib": plan.n * W * 4 / 2**30,
            "peak_gib": peak / 2**30, "peak_above_input_gib": (peak - base) / 2**30}
    emit({"phase": f"ntt_2^{plan.logn}_split", **info})
    got = {k: split[f"{k}_launches"] for k in SPLIT}
    if got != {**dict.fromkeys(SPLIT, 0), **want}:
        raise AssertionError(f"ntt 2^{plan.logn}: device operations {got}, want {want} "
                             f"and nothing else")
    return info


def phase_ntt_parity(imad_rate: float, seed: int, device):
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT

    names = ("ntt_base", "mul_lm", "twiddle_mul")
    errs = dict.fromkeys(names, 0)
    for field in NTT_FIELDS:
        checked = []
        for name, kern, plain, shape in ntt_kernel_cases(FIELDS[field], seed, device):
            e = max_abs_err(kern(), plain())
            errs[name] = max(errs[name], e)
            checked.append({"kernel": name, **shape, "max_abs_err": e})
        torch.cuda.synchronize()
        emit({"phase": "ntt_parity", "field": field, "shape": "small", "cases": checked})
        if any(c["max_abs_err"] for c in checked):
            raise AssertionError(f"{field}: NTT kernel differs from its plain version")
    dev = torch.device("cuda", torch.cuda.current_device())     # the plan's device, indexed
    plan = FusedNTT(FIELDS["bls12_381_fr"], 27, device=dev)
    timing = ntt_main_timing(plan, imad_rate, seed, dev)
    emit({"phase": "ntt_parity", "field": "bls12_381_fr", "shape": "main path (2^27)",
          "kernels": timing})
    for key, t in timing.items():
        name = next(nm for nm in names if key.startswith(nm))
        errs[name] = max(errs[name], t["max_abs_err"])
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("NTT kernel differs from its plain version at the main shapes")
    ntt_transform_split(plan, seed, dev, {"ntt_base": 3, "twiddle_mul": 2})
    del plan
    ntt_transform_split(FusedNTT(FIELDS["bls12_381_fr"], 16, device=dev), seed, dev,
                        {"ntt_base": 2, "mul_lm": 1})
    return errs, timing


# --------------------------------------------------------- phases 6 and 7
def host_vector(n: int, seed: int, parts: int = 8):
    """(n, 8) uint32 words of random values below 2^254 < p (bls12_381_fr):
    the raw 64-bit output of `parts` numpy generators spawned from the seed,
    filled in threads (numpy releases the GIL there), the top word masked as
    bench.py:156-157 does."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    w = np.empty((n, 8), dtype=np.uint32)
    flat = w.reshape(-1).view(np.uint64)
    step = -(-flat.size // parts)

    def fill(i, seq):
        part = flat[i * step:(i + 1) * step]
        part[:] = np.random.PCG64(seq).random_raw(part.size)

    with ThreadPoolExecutor(parts) as ex:
        list(ex.map(fill, range(parts), np.random.SeedSequence(seed).spawn(parts)))
    w[:, 7] &= 0x3FFFFFFF
    return w


def host_ntt(vals, w: int, p: int):
    """X[k] = sum_i vals[i] w^(ik) by recursive Cooley-Tukey on Python ints
    (the algorithm of scripts/gen_ntt_vectors.py:43-57, which shares nothing
    with either package)."""
    n = len(vals)
    if n == 1:
        return vals[:]
    even = host_ntt(vals[0::2], w * w % p, p)
    odd = host_ntt(vals[1::2], w * w % p, p)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % p
        out[k] = (even[k] + t) % p
        out[k + n // 2] = (even[k] - t) % p
        wk = wk * w % p
    return out


def word_ints(words) -> list:
    """(n, W) uint32 words -> Python ints."""
    return [int.from_bytes(row.tobytes(), "little") for row in words]


def evaluate_on_card(spec, x, root: int, ks, chunk: int = 1 << 22) -> list:
    """sum_i x[i] root^(ik) mod p for each k, without any NTT kernel: per
    chunk, Field.powers of root^k (K1) times root^(k c0), times x (K1:
    canonical x against a Montgomery power gives the canonical product),
    then the products' 16-bit limbs summed as integers on the card."""
    import numpy as np
    import torch

    from blaze_tpu_torch.fields import Field, int_to_words
    from blaze_tpu_torch.fields.kernel_ops import words_to_limbs16

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


def run_ntt_client(client, vec, buf: int = 0):
    """set_data -> start_process -> wait_result -> result on one slot, with a
    host barrier after set_data so the upload is not counted as transform
    time.  Returns (bytes, phase seconds)."""
    import torch

    from blaze_tpu_torch.runtime import NTTInput

    t0 = time.perf_counter()
    client.set_data(NTTInput(data=memoryview(vec).cast("B"), buf_host=buf))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    client.start_process(buf)
    client.wait_result(buf)
    t2 = time.perf_counter()
    out = client.result(buf)
    t3 = time.perf_counter()
    return out, {"set_data_s": t1 - t0, "start_to_wait_s": t2 - t1, "result_s": t3 - t2}


def check_launches(phase: str, counts: dict, needs) -> None:
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched: {missing}")


def phase_ntt_2e27(seed: int, logn: int = 27) -> dict:
    """Phase 6; returns the launch counts of the client run."""
    import numpy as np
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.fields import FIELDS, int_to_words
    from blaze_tpu_torch.runtime import NTTClient, NTTInit, NTTInput

    spec = FIELDS["bls12_381_fr"]
    n, p = 1 << logn, spec.p
    root = spec.root_of_unity(logn)
    t0 = time.perf_counter()
    vecs = [host_vector(n, seed + i) for i in range(3)]
    gen_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    fwd = NTTClient(NTTInit(field="bls12_381_fr", logn=logn))
    plan_s = time.perf_counter() - t0
    serial, digests = [], []
    for v in vecs:
        out, secs = run_ntt_client(fwd, v)
        serial.append(secs)
        digests.append(np.frombuffer(out, "<u8").sum(dtype=np.uint64))
        del out
    # the reference's double-buffered order (integration_ntt.rs:103-136):
    # start the kernel on one slot, drain and refill the other, then wait
    outs = [None] * 3
    t0 = time.perf_counter()
    for i in range(3 + 2):
        host, kern = i % 2, 1 - i % 2
        if 1 <= i <= 3:
            fwd.start_process(kern)
        if i >= 2:
            outs[i - 2] = fwd.result(host)
        if i <= 2:
            fwd.set_data(NTTInput(data=memoryview(vecs[i]).cast("B"), buf_host=host))
            vecs[i] = None
        if 1 <= i <= 3:
            fwd.wait_result(kern)
    pipelined_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"ntt_2^{logn}", counts, ("ntt_base", "twiddle_mul"))
    best = min(s["start_to_wait_s"] for s in serial)
    serial_sum = sum(sum(s.values()) for s in serial)
    emit({"phase": f"ntt_2^{logn}", "field": spec.name, "n": n, "input_gen_s": gen_s,
          "plan_s": plan_s, "serial": serial,
          "elements_per_s_one_transform": n / best,
          "pipelined_3_s": pipelined_s, "serial_3_sum_s": serial_sum,
          "overlapped": pipelined_s < serial_sum,
          "max_memory_allocated_gib": peak / 2**30, "launches": counts})

    # checks on each pipelined output: equal to the serial one, inverse
    # roundtrip to the input bytes, and evaluations at sampled indices
    rng = np.random.default_rng(seed)
    ks = [0, 1, n - 1] + [int(v) for v in rng.integers(2, n - 1, size=8)]
    inv = NTTClient(NTTInit(field="bls12_381_fr", logn=logn), inverse=True)
    checks = []
    for i in range(3):
        o, outs[i] = outs[i], None
        same = np.frombuffer(o, "<u8").sum(dtype=np.uint64) == digests[i]
        got = word_ints(np.frombuffer(o, "<u4").reshape(n, 8)[ks])
        inv.set_data(NTTInput(data=o, buf_host=0))
        del o
        inv.start_process(0)
        v = host_vector(n, seed + i)
        inv.wait_result(0)
        back = inv.result(0)
        roundtrip = np.array_equal(np.frombuffer(back, "<u4"), v.reshape(-1))
        del back
        xdev = torch.from_numpy(v.view(np.int32)).to(fwd.ctx.device)
        del v
        want = evaluate_on_card(spec, xdev, root, ks)
        del xdev
        checks.append({"vector": i, "equals_serial": bool(same), "roundtrip": roundtrip,
                       "evaluations_match": got == want})
    # a sparse input against host sums
    rnd = random.Random(seed)
    pos = rnd.sample(range(n), 16)
    coef = [rnd.randrange(p) for _ in range(16)]
    sp = np.zeros((n, 8), dtype=np.uint32)
    for i, c in zip(pos, coef):
        sp[i] = int_to_words(c, 8)
    out, _ = run_ntt_client(fwd, sp)
    del sp
    kk = [0, 1, n - 1] + rnd.sample(range(2, n - 1), 61)
    got = word_ints(np.frombuffer(out, "<u4").reshape(n, 8)[kk])
    del out
    want = [sum(c * pow(root, i * k, p) for i, c in zip(pos, coef)) % p for k in kk]
    emit({"phase": f"ntt_2^{logn}_checks", "outputs": checks, "sparse_64_match": got == want,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    bad = [c for c in checks if not (c["equals_serial"] and c["roundtrip"]
                                     and c["evaluations_match"])]
    if bad or got != want:
        raise AssertionError(f"ntt_2^{logn}: output check failed: {bad} sparse={got == want}")
    return counts


def phase_ntt_small(seed: int) -> dict:
    """Phase 7; returns the launch counts of its client runs."""
    import glob
    import re

    import numpy as np

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.runtime import NTTClient, NTTInit

    spec = FIELDS["bls12_381_fr"]
    total = {}
    for logn, needs in ((16, ("ntt_base", "mul_lm")), (20, ("ntt_base", "twiddle_mul"))):
        n = 1 << logn
        v = host_vector(n, seed + logn)
        _build.reset_launches()
        fwd = NTTClient(NTTInit(field=spec.name, logn=logn))
        out, secs = run_ntt_client(fwd, v)
        counts = dict(_build.LAUNCHES)
        check_launches(f"ntt_2^{logn}", counts, needs)
        t0 = time.perf_counter()
        want = host_ntt(word_ints(v), spec.root_of_unity(logn), spec.p)
        host_s = time.perf_counter() - t0
        ok = out == b"".join(x.to_bytes(spec.nbytes, "little") for x in want)
        back, _ = run_ntt_client(NTTClient(NTTInit(field=spec.name, logn=logn), inverse=True), out)
        rt = back == v.tobytes()
        emit({"phase": f"ntt_2^{logn}", "n": n, **secs, "host_ntt_s": host_s,
              "host_ntt": "match" if ok else "MISMATCH", "roundtrip": rt, "launches": counts})
        if not (ok and rt):
            raise AssertionError(f"ntt_2^{logn}: differs from the host NTT or roundtrip")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
    goldens = {}
    for inf in sorted(glob.glob(str(ROOT / "tests" / "fixtures" / "ntt_*_2e*.in"))):
        m = re.match(r"ntt_(.+)_2e(\d+)\.in$", Path(inf).name)
        raw, want = Path(inf).read_bytes(), Path(inf[:-3] + ".out").read_bytes()
        init = NTTInit(field=m.group(1), logn=int(m.group(2)))
        out, _ = run_ntt_client(NTTClient(init), raw)
        back, _ = run_ntt_client(NTTClient(init, inverse=True), want)
        goldens[Path(inf).stem] = out == want and back == raw
    emit({"phase": "ntt_goldens", "pairs": goldens})
    if not goldens or not all(goldens.values()):
        raise AssertionError(f"ntt goldens: {goldens}")
    return total


# ------------------------------------------------------- pipeline phase
PIPELINE_UNIQUE = 256          # subgroup points, tiled to the MSM's size


def pipeline_terms(r: int, n: int, seed: int):
    """The pipeline phase's three coefficient batches as (row, value)
    terms: e_1 (scalars W^i), e_k for an odd k > 1 (scalars (W^k)^i) and
    a e_j + b e_k' (a G(W^j) + b G(W^k') by linearity), the odd rows k, j,
    k' (an odd power of W keeps its order, so no geometric ratio divides
    by zero) and a, b from the seed."""
    rnd = random.Random(seed)
    k, j, k2 = (2 * v + 1 for v in rnd.sample(range(1, min(n, 1 << 20) // 2), 3))
    return [((1, 1),), ((k, 1),), ((j, rnd.randrange(1, r)), (k2, rnd.randrange(1, r)))]


def pipeline_trace_split(trace: Path, wall_s: float) -> dict:
    """Device time per stream from a torch.profiler Chrome trace: the NTT's
    stream (the one that ran ntt_base_kernel; None when the trace holds no
    NTT kernel) and every other (the MSM's), their union, the card's idle
    share of `wall_s`, and each stream's operations and milliseconds."""
    events = [e for e in json.loads(trace.read_text()).get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        return {"ntt_stream_ms": None, "msm_stream_ms": None, "device_busy_ms": None,
                "idle_share": None}
    streams = {}
    for e in events:
        st = streams.setdefault(str(e["args"].get("stream")), {"ops": 0, "ms": 0.0})
        st["ops"] += 1
        st["ms"] += e["dur"] / 1e3
    ntt_streams = {str(e["args"].get("stream")) for e in events
                   if "ntt_base_kernel" in e["name"]}
    ntt = sum(streams[k]["ms"] for k in ntt_streams)
    spans, busy, end = sorted((e["ts"], e["ts"] + e["dur"]) for e in events), 0.0, None
    for a, b in spans:                           # the union of the device intervals
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return {"ntt_stream_ms": ntt if ntt_streams else None,
            "msm_stream_ms": sum(v["ms"] for v in streams.values()) - ntt,
            "device_busy_ms": busy / 1e3, "device_ops": len(events),
            "idle_share": 1 - busy / 1e6 / wall_s, "streams": streams}


def phase_pipeline(seed: int, ntt_logn: int = 27, msm_logn: int = 24) -> dict:
    """The proof pipeline (ProofPipeline, BLS12-381) at the reference's NTT
    size and the headline MSM size: three batches made on the card, run
    serially (one batch at a time, synchronised, launch counts per batch)
    and then through run_batches; the results must be equal byte for byte
    and each equal its geometric oracle.  One more pipelined run is
    profiled around its middle batch (DeviceContext.profile).  Returns the
    launch counts of the serial runs."""
    import shutil

    import numpy as np
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.fields import int_to_words
    from blaze_tpu_torch.msm import points_to_resident
    from blaze_tpu_torch.oracle import ECOracle
    from blaze_tpu_torch.oracle.gen import points_to_affine_words
    from blaze_tpu_torch.pipeline import ProofPipeline, geometric_msm_oracle
    from blaze_tpu_torch.runtime.device import TRACE_FILE

    spec = CURVES["bls12_381"]
    cv, r = Curve(spec), spec.fr.p
    n, m = 1 << ntt_logn, 1 << msm_logn
    U = min(PIPELINE_UNIQUE, m)
    t0 = time.perf_counter()
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(U)]
    terms = pipeline_terms(r, n, seed)
    w = spec.fr.root_of_unity(ntt_logn)
    geo = {}
    for t in terms:
        for row, _ in t:
            geo[row] = geometric_msm_oracle(spec, U, m, pow(w, row, r), upoints)
    expected = [oracle.msm([geo[row] for row, _ in t], [v for _, v in t]) for t in terms]
    oracle_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pipe = ProofPipeline(cv, ntt_logn, msm_logn)
    dev = pipe.ctx.device
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    resident = points_to_resident(cv, pts).repeat(1, m // U)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def batch(t):
        x = torch.zeros((n, spec.fr.nwords), dtype=torch.int32, device=dev)
        for row, v in t:
            x[row] = torch.from_numpy(int_to_words(v, spec.fr.nwords).view(np.int32)).to(dev)
        return x

    serial, serial_s, counts = [], [], []
    for t in terms:
        x = batch(t)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        (res,) = pipe.run_batches([x], resident)
        torch.cuda.synchronize()
        serial_s.append(time.perf_counter() - t0)
        counts.append(dict(_build.LAUNCHES))
        serial.append(res.cpu().numpy().tobytes())
        del x, res
    # one batch's NTT and scalars alone on the card (CUDA events): the work
    # the side stream does per batch
    x = batch(terms[0])
    ntt_ms = cuda_ms(lambda: pipe.scalars(x), 3)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    piped = [res.cpu().numpy().tobytes()
             for res in pipe.run_batches((batch(t) for t in terms), resident)]
    pipelined_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    trace_dir = ROOT / "build" / "pipeline_trace"
    runs = pipe.run_batches((batch(t) for t in terms), resident)
    profiled = [next(runs).cpu().numpy().tobytes()]
    try:
        with pipe.ctx.profile(trace_dir):
            t0 = time.perf_counter()
            profiled.append(next(runs).cpu().numpy().tobytes())
            profiled_s = time.perf_counter() - t0
        split = pipeline_trace_split(trace_dir / TRACE_FILE, profiled_s)
        split["trace_mib"] = (trace_dir / TRACE_FILE).stat().st_size / 2**20
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    profiled += [res.cpu().numpy().tobytes() for res in runs]

    oracle_ok = []
    for raw, want in zip(serial, expected):
        X, Y, Z = (int.from_bytes(raw[i * 4 * cv.nwords:(i + 1) * 4 * cv.nwords], "little")
                   for i in range(3))
        p = spec.fq.p
        # Montgomery words x R: z-normalisation divides the R out
        zi = pow(Z, -1, p) if Z % p else None
        got = None if zi is None else (X * zi % p, Y * zi % p)
        oracle_ok.append(got == want)
    # one batch's launches: K7 per level and K9 (or K8 for a narrow cell)
    # per later level, K2 per chunk of the MSM, K6 once; at (2^27, 2^24):
    # K7 x3, K9 x2, K2 x32, K6 x1 and no K8
    k8 = sum(pipe.plan._takes_k8(d) for d in range(len(pipe.plan.levels) - 1))
    want = {"ntt_base": len(pipe.plan.levels), "mul_lm": k8,
            "twiddle_mul": len(pipe.plan.levels) - 1 - k8,
            "scan_mixed": -(-m // (1 << pipe.msm.config.chunk_log2)), "fold_horner": 1,
            "poseidon_perm": 0}
    per_batch = pipelined_s / len(terms)
    info = {"curve": "bls12_381", "ntt_logn": ntt_logn, "msm_logn": msm_logn,
            "unique_points": U, "batches": [[[row, str(v)] for row, v in t] for t in terms],
            "oracle_s": oracle_s, "setup_s": setup_s,
            "serial_s": serial_s, "serial_per_batch_s": sum(serial_s) / len(terms),
            "pipelined_s": pipelined_s, "pipelined_per_batch_s": per_batch,
            "proofs_per_s": 1 / per_batch, "ntt_and_scalars_ms": ntt_ms,
            "profiled_batch_s": profiled_s, **split,
            "max_memory_allocated_gib": peak / 2**30,
            "launches_per_batch": counts, "launches_want": want,
            "pipelined_equals_serial": piped == serial,
            "profiled_equals_serial": profiled == serial,
            "distinct_results": len(set(serial)) == len(serial), "oracle": oracle_ok}
    emit({"phase": "pipeline", **info})
    for i, c in enumerate(counts):
        check_msm_launches(f"pipeline batch {i}", c)
        bad = {k: c[k] for k, v in want.items() if c[k] != v}
        if bad:
            raise AssertionError(f"pipeline batch {i}: launches {bad}, want {want}")
    if not (all(oracle_ok) and piped == serial and profiled == serial
            and len(set(serial)) == len(serial)):
        raise AssertionError(f"pipeline: oracle {oracle_ok}, pipelined == serial "
                             f"{piped == serial}, profiled == serial {profiled == serial}, "
                             f"distinct {len(set(serial)) == len(serial)}")
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# ------------------------------------------------------------ the dist phase
def timed_run(fn):
    """fn() once, synchronised: its result, wall seconds, device ms (CUDA
    events around it), the launches of each kernel and the peak memory
    above what was allocated before."""
    import torch

    from blaze_tpu_torch import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    return out, {"wall_s": wall, "device_ms": start.elapsed_time(end), "launches": counts,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "peak_above_inputs_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def batched_kernel_cases(spec, seed: int, device):
    """(name, kernel call, plain call, shape) for K7 and K9 at batched maps
    (FusedNTT.ntt_batch's levels, fused.batch_level), compared whole: B = 8
    transforms of 2^10 (klog 4: three levels) read at element stride 16
    into (n, B) rows, and B = 4 of 2^9 (klog 5: two levels) read as (B, n)
    rows into (B, n) rows; each level's K7 from the plan's input (level 0)
    or a random buffer, each twiddle's K9."""
    import torch

    from blaze_tpu_torch.ntt import FusedNTT
    from blaze_tpu_torch.ntt.fused import batch_level

    W = spec.nwords
    cases = []
    for i, (logn, klog, B, src, minor) in enumerate(((10, 4, 8, (16, 1), True),
                                                     (9, 5, 4, (1, 512), False))):
        plan = FusedNTT(spec, logn, klog=klog, device=device)
        n = plan.n
        x = rand_words(spec, ((n - 1) * src[0] + (B - 1) * src[1] + 1, W), seed + i, device)
        buf = rand_words(spec, (n * B, W), seed + 10 + i, device)
        for d, lv0 in enumerate(plan.levels):
            lv = batch_level(lv0, d, logn, B, src, minor)
            pack = plan._packs[(lv.a, False)]
            inp = x if d == 0 else buf
            shape = {"logn": logn, "B": B, "minor": int(minor), "level": d, "K": 1 << lv.a,
                     "lanes": lv.lanes, "fields": len(lv.omap.fields)}
            k, out = plan.kern, torch.zeros_like(buf)
            cases.append(("ntt_base",
                          lambda inp=inp, pack=pack, lv=lv, k=k, out=out: k.ntt_base(
                              inp, pack, lv.lanes, lv.xmap, out=out.clone(), omap=lv.omap),
                          lambda inp=inp, pack=pack, lv=lv, k=k, out=out: k.ntt_base_plain(
                              inp, pack, lv.lanes, lv.xmap, out=out.clone(), omap=lv.omap),
                          shape))
            if d + 1 < len(plan.levels):
                t1, t2 = plan._tabs[(d, False)]
                cases.append(("twiddle_mul",
                              lambda t1=t1, t2=t2, lv=lv, k=k, buf=buf: k.twiddle_mul(
                                  buf, t1, t2, lv.vshift, lv.fields),
                              lambda t1=t1, t2=t2, lv=lv, k=k, buf=buf: k.twiddle_mul_plain(
                                  buf, t1, t2, lv.vshift, lv.fields),
                              {"logn": logn, "B": B, "minor": int(minor), "depth": d}))
    return cases


def four_step_timing(dntt, imad_rate: float, seed: int, device) -> tuple:
    """K7 at each batched level of the 2^27 four-step's sub-plans and K9 at
    their twiddles and at the inter-pass twiddle (this rank's tables), at
    the main path's maps: time (CUDA events), bound, and the kernel's
    output against the plain version on a cut (K7 2^11 lanes, K9 2^20
    rows).  Returns (timing, max error per kernel)."""
    import torch

    from blaze_tpu_torch.ntt.fused import batch_level

    W = dntt.spec.nwords
    n = dntt.n
    lane_cut, row_cut = 1 << 11, 1 << 20
    x = rand_words(dntt.spec, (n, W), seed, device)
    buf = rand_words(dntt.spec, (n, W), seed + 1, device)
    timing, errs = {}, {"ntt_base": 0, "twiddle_mul": 0}
    steps = (("cols", dntt.plan1, dntt.ncols, (dntt.n2, 1), True),
             ("rows", dntt.plan2, dntt.n1 // dntt.ndev, (1, dntt.n2), False))
    for tag, plan, B, src, minor in steps:
        k = plan.kern
        for d, lv0 in enumerate(plan.levels):
            lv = batch_level(lv0, d, plan.logn, B, src, minor)
            pack, K = plan._packs[(lv.a, False)], 1 << lv.a
            inp = x if d == 0 else buf
            ms = cuda_ms(lambda inp=inp, lv=lv, pack=pack: k.ntt_base(
                inp, pack, lv.lanes, lv.xmap, out=buf, omap=lv.omap), 3)
            got = k.ntt_base(inp, pack, lv.lanes, lv.xmap, out=torch.zeros_like(buf),
                             omap=lv.omap)
            cut = min(lane_cut, lv.lanes)
            want, plain_ms = once_ms(lambda inp=inp, lv=lv, pack=pack: k.ntt_base_plain(
                inp, pack, cut, lv.xmap, out=torch.zeros_like(buf), omap=lv.omap))
            rows = lv.omap.offsets(K, cut, device).reshape(-1)
            e = max_abs_err(got[rows], want[rows])
            del got, want
            shape = {"K": K, "lanes": lv.lanes}
            bound, by = work_bound_ms("ntt_base", shape, W, imad_rate)
            timing[f"k7_{tag}_level{d}"] = {**shape, "fields": len(lv.omap.fields), "ms": ms,
                                            "bound_ms": bound, "bound_by": by,
                                            "plain_ms": plain_ms, "plain_lanes": cut,
                                            "max_abs_err": e}
            errs["ntt_base"] = max(errs["ntt_base"], e)
            if d + 1 < len(plan.levels):
                t1, t2 = plan._tabs[(d, False)]
                twiddles = [(f"k9_{tag}_depth{d}", t1, t2, lv.vshift, lv.fields)]
            else:
                twiddles = []
            if tag == "cols" and d + 1 == len(plan.levels):
                t1, t2 = dntt._tw[False]
                logc = dntt.ncols.bit_length() - 1
                twiddles.append(("k9_inter_pass", t1, t2, logc, ((0, logc, 0),)))
            for key, t1, t2, vs, f in twiddles:
                ms = cuda_ms(lambda t1=t1, t2=t2, vs=vs, f=f: k.twiddle_mul(
                    buf, t1, t2, vs, f, out=buf), 3)
                y = buf[:min(row_cut, n)].clone()
                got = k.twiddle_mul(y, t1, t2, vs, f)
                want, plain_ms = once_ms(lambda y=y, t1=t1, t2=t2, vs=vs, f=f:
                                         k.twiddle_mul_plain(y, t1, t2, vs, f))
                e = max_abs_err(got, want)
                shape = {"A": t1.shape[0], "J": t1.shape[1], "S": t2.shape[1],
                         "B": n // (t1.shape[0] * t1.shape[1] * t2.shape[1])}
                bound, by = work_bound_ms("twiddle_mul", shape, W, imad_rate)
                timing[key] = {**shape, "ms": ms, "bound_ms": bound, "bound_by": by,
                               "plain_ms": plain_ms, "plain_rows": y.shape[0], "max_abs_err": e}
                errs["twiddle_mul"] = max(errs["twiddle_mul"], e)
                del y, got, want
    del x, buf
    torch.cuda.empty_cache()
    return timing, errs


def phase_dist(imad_rate: float, seed: int, ntt_logn: int = 27, msm_logn: int = 24,
               logn1: int = 13, device=None) -> tuple:
    """The sharded paths through their public entry points on the card, NCCL,
    every mesh of one rank (a group of one from make_mesh): batched K7/K9
    against their plain versions; DistributedMSM at 2^msm_logn on BLS12-381
    (full-width distinct scalars, 256 subgroup points tiled) against the
    single-card MSM.__call__ and the oracle; DistributedNTT at 2^ntt_logn on
    bls12_381_fr (logn1) against FusedNTT.ntt word for word, its inverse
    back to the input, one transform's device time split into K7, K9, NCCL
    and the rest; run_dist at (ntt_logn, msm_logn) on {dp: 1, sp: 1}
    against its geometric oracle.  `device` (default: the current card)
    picks the meshes' device type: the CPU rehearses the phase at small
    sizes.  Returns (errors, launches, info)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.dist import DistributedMSM, DistributedNTT, make_mesh
    from blaze_tpu_torch.fields import FIELDS, int_to_words
    from blaze_tpu_torch.msm import MSM, points_to_resident
    from blaze_tpu_torch.oracle import ECOracle
    from blaze_tpu_torch.oracle.gen import points_to_affine_words
    from blaze_tpu_torch.pipeline import ProofPipeline, geometric_msm_oracle

    dev = device or torch.device("cuda", torch.cuda.current_device())
    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    fr = FIELDS["bls12_381_fr"]
    errs = {"ntt_base": 0, "twiddle_mul": 0}
    launches, info = {}, {}

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def aff(res):
        X, Y, Z = (int.from_bytes(res[i].cpu().numpy().tobytes(), "little") for i in range(3))
        p = spec.fq.p
        return (X * pow(Z, -1, p) % p, Y * pow(Z, -1, p) % p) if Z % p else None

    # ---- batched K7 / K9 against their plain versions, whole
    checked = []
    for field in NTT_FIELDS:
        for name, kern, plain, shape in batched_kernel_cases(FIELDS[field], seed, dev):
            e = max_abs_err(kern(), plain())
            errs[name] = max(errs[name], e)
            checked.append({"field": field, "kernel": name, **shape, "max_abs_err": e})
    emit({"phase": "dist_batched_parity", "cases": checked})
    if any(c["max_abs_err"] for c in checked):
        raise AssertionError("a batched K7/K9 call differs from its plain version")

    try:
        mesh = make_mesh({"dp": 1}, device_type=dev.type)
        info["backend"] = str(dist.get_backend())
        # ---- DistributedMSM at 2^msm_logn against MSM.__call__ and the oracle
        m = 1 << msm_logn
        t0 = time.perf_counter()
        upoints, scal_np, want = tiled_arrays(spec, m, seed + 5)
        pts256 = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
        resident = points_to_resident(cv, pts256).repeat(1, m // 256)
        scal = torch.from_numpy(scal_np.view(np.int32)).to(dev).t().contiguous()
        gen_s = time.perf_counter() - t0
        # in turns with the single-card MSM on the same inputs: sharded,
        # single, single, sharded (the first run of a shape grows the
        # allocator's cache)
        dmsm, single = DistributedMSM(cv, mesh, axis="dp"), MSM(cv)
        runs = [timed_run(lambda f=f: f(resident, scal))
                for f in (dmsm, single, single, dmsm)]
        got = aff(runs[0][0])
        ok = {"oracle": got == want,
              "equals_single_card": all(aff(r) == got for r, _ in runs)}
        run = runs[0][1]
        info["msm"] = {"n": m, "input_gen_s": gen_s, **run,
                       "wall_s_in_turns": {"sharded": [runs[0][1]["wall_s"], runs[3][1]["wall_s"]],
                                           "single_card": [runs[1][1]["wall_s"],
                                                           runs[2][1]["wall_s"]]},
                       **ok}
        emit({"phase": "dist_msm", **info["msm"]})
        add_launches(run["launches"])
        check_msm_launches("dist_msm", run["launches"])
        if not all(ok.values()) or runs[3][1]["launches"] != run["launches"]:
            raise AssertionError(f"DistributedMSM 2^{msm_logn}: {ok}")
        del resident, scal, runs

        # ---- DistributedNTT at 2^ntt_logn against FusedNTT, and back
        from blaze_tpu_torch.ntt import FusedNTT

        mesh_sp = make_mesh({"sp": 1}, device_type=dev.type)
        t0 = time.perf_counter()
        dntt = DistributedNTT(fr, ntt_logn, mesh_sp, axis="sp", logn1=logn1)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        timing, kerr = four_step_timing(dntt, imad_rate, seed, dev)
        for k_, v in kerr.items():
            errs[k_] = max(errs[k_], v)
        emit({"phase": "dist_ntt_kernels", "kernels": timing})
        if any(kerr.values()):
            raise AssertionError("a four-step K7/K9 call differs from its plain version")
        x = rand_words(fr, (1 << ntt_logn, fr.nwords), seed + 6, dev)
        xk, run = timed_run(lambda: dntt.ntt(x))
        add_launches(run["launches"])
        want_counts = {"ntt_base": len(dntt.plan1.levels) + len(dntt.plan2.levels),
                       "twiddle_mul": len(dntt.plan1.levels) + len(dntt.plan2.levels) - 1,
                       "mul_lm": 0}
        bad = {k_: run["launches"][k_] for k_, v in want_counts.items()
               if run["launches"][k_] != v}
        ntt_ms = cuda_ms(lambda: dntt.ntt(x), 3)
        split = device_split(lambda: dntt.ntt(x))
        nat = dntt.spectral_to_natural(xk)
        fused = FusedNTT(fr, ntt_logn, device=dev)
        ref = fused.ntt(x)
        equal = bool(torch.equal(nat, ref))
        del nat, ref
        fused_ms = cuda_ms(lambda: fused.ntt(x), 3)
        del fused
        back, run_inv = timed_run(lambda: dntt.intt(xk))
        roundtrip = bool(torch.equal(back, x))
        del back, xk, x
        info["ntt"] = {"n": 1 << ntt_logn, "logn1": logn1, "sub_parts": [dntt.plan1.parts,
                                                                         dntt.plan2.parts],
                       "plan_s": plan_s, **run, "transform_ms": ntt_ms,
                       "fused_plan_transform_ms": fused_ms, "split": split,
                       "intt": run_inv, "equals_fused_ntt": equal, "roundtrip": roundtrip,
                       "launches_want": want_counts}
        # late in a full run the profiler has recorded no device event at
        # all (PERF.md §7): then the split is not measured, and the launch
        # counts and CUDA event times stand alone
        captured = split["device_ms"] > 0
        info["ntt"]["split_captured"] = captured
        emit({"phase": "dist_ntt", **info["ntt"]})
        split_bad = captured and {k_: split[f"{k_}_launches"] for k_ in SPLIT} != {
            **dict.fromkeys(SPLIT, 0), **want_counts}
        if bad or split_bad or not (equal and roundtrip):
            raise AssertionError(f"DistributedNTT 2^{ntt_logn}: launches {bad}, equal {equal}, "
                                 f"roundtrip {roundtrip}, profiled device ops {split}")
        torch.cuda.empty_cache()

        # ---- run_dist at (ntt_logn, msm_logn) on {dp: 1, sp: 1}
        mesh2 = make_mesh({"dp": 1, "sp": 1}, device_type=dev.type)
        r = spec.fr.p
        terms = pipeline_terms(r, 1 << ntt_logn, seed + 7)[2]       # a e_j + b e_k'
        up = upoints                                 # tiled_arrays' subgroup points
        U = len(up)
        oracle = ECOracle(spec)
        w = spec.fr.root_of_unity(ntt_logn)
        t0 = time.perf_counter()
        want = oracle.msm([geometric_msm_oracle(spec, U, m, pow(w, row, r), up)
                           for row, _ in terms], [v for _, v in terms])
        oracle_s = time.perf_counter() - t0
        pipe = ProofPipeline(cv, ntt_logn, msm_logn, mesh=mesh2)
        pts = torch.from_numpy(points_to_affine_words(spec, up).view(np.int32)).to(dev)
        resident = points_to_resident(cv, pts).repeat(1, m // U)
        x = torch.zeros((1 << ntt_logn, fr.nwords), dtype=torch.int32, device=dev)
        for row, v in terms:                                       # Montgomery form
            x[row] = torch.from_numpy(int_to_words(v * fr.r % r, fr.nwords).view(np.int32))
        got, run = timed_run(lambda: pipe.run_dist(x, resident))
        add_launches(run["launches"])
        ok = aff(got) == want
        info["run_dist"] = {"ntt_logn": ntt_logn, "msm_logn": msm_logn, "unique_points": U,
                            "terms": [[row, str(v)] for row, v in terms],
                            "oracle_s": oracle_s, **run, "oracle": ok}
        emit({"phase": "run_dist", **info["run_dist"]})
        check_msm_launches("run_dist", run["launches"])
        if run["launches"]["ntt_base"] != want_counts["ntt_base"] or not ok:
            raise AssertionError(f"run_dist: oracle {ok}, launches {run['launches']}")
        del x, resident, got
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return errs, launches, info


# ------------------------------------------------------- Poseidon phases
POSEIDON_FIELD = "bls12_381_fr"


def near_p_states(spec, t: int, B: int, seed: int, device):
    """(t, W, B) canonical words: random values below 2^(bits-1), and every
    7th state's elements p-1-k (k < 5): canonical inputs near p, which
    convert_in must not find reduced by accident."""
    import numpy as np
    import torch

    from blaze_tpu_torch.fields import int_to_words

    W = spec.nwords
    x = rand_words(spec, (t, W, B), seed, device)
    near = torch.from_numpy(np.stack([int_to_words(spec.p - 1 - k, W) for k in range(5)])
                            .view(np.int32)).to(device)
    lanes = torch.arange(0, B, 7, device=device)
    x[:, :, lanes] = near[torch.arange(lanes.numel(), device=device) % 5].t()[None]
    return x


def redc_edge_inputs(spec, t: int, seed: int, device):
    """(t, W, B) pairs for sum_products: T = t (p-1)^2 (the largest sum of
    canonical products), 0, t, t (p-1), near-p mixes, then random lanes."""
    import numpy as np
    import torch

    from blaze_tpu_torch.fields import int_to_words

    p, W = spec.p, spec.nwords
    rng = random.Random(seed)
    pairs = [(p - 1, p - 1), (0, p - 1), (1, 1), (p - 1, 1), (p - 2, p - 1), (p - 1, p - 3)]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(58)]

    def lm(vals):
        w = np.stack([int_to_words(v, W) for v in vals])             # (B, W)
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(w.T[None], (t, W, len(vals)))).view(np.int32)).to(device)

    return lm([a for a, _ in pairs]), lm([c for _, c in pairs])


def singular_block(params):
    """`params` with row 2 of the MDS copied from row 1 past column 0: its
    lower-right (t-1) x (t-1) block is singular, so the instance has no
    sparse form and K10 runs its dense rounds."""
    from blaze_tpu_torch.hash import params_from_reference

    mds = [list(row) for row in params.mds]
    mds[2][1:] = mds[1][1:]
    return params_from_reference(params.spec, params.t, params.alpha, params.r_f, params.r_p,
                                 params.round_constants, mds)


def poseidon_main_timing(imad_rate: float, seed: int, device):
    """K10 at the height-9 tree's shapes on bls12_381_fr — the leaf sponge
    (t = 12, B = 2^24, convert_in) and the first node level (t = 9,
    B = 2^21): one warm call whose first 2^10 states are held against the
    plain version on the same cut, then timed calls (CUDA events).  The
    bound counts the sparse schedule's work; dense_bound_ms the dense
    rounds' (the TPU kernel's)."""
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import PoseidonKernels, generate_params

    spec = FIELDS[POSEIDON_FIELD]
    W, cut = spec.nwords, 1 << 10
    timing = {}
    for key, t, B, conv in (("poseidon_perm", 12, 1 << 24, True),
                            ("poseidon_perm_t9", 9, 1 << 21, False)):
        params = generate_params(spec, t)
        k = PoseidonKernels.for_params(params)
        x = rand_words(spec, (t, W, B), seed + t, device)
        e = max_abs_err(k.permute_lm(x, convert_in=conv)[:, :, :cut],
                        k.permute_lm_plain(x[:, :, :cut].contiguous(), conv))
        ms = cuda_ms(lambda: k.permute_lm(x, convert_in=conv), 1 if B > 1 << 22 else 3)
        _, plain_ms = once_ms(lambda: k.permute_lm_plain(x[:, :, :cut].contiguous(), conv))
        shape = {"t": t, "B": B, "r_f": params.r_f, "r_p": params.r_p, "convert_in": int(conv),
                 "sparse": int(k.sparse)}
        bound, bound_by = work_bound_ms("poseidon_perm", shape, W, imad_rate)
        dense, _ = work_bound_ms("poseidon_perm", {**shape, "sparse": 0}, W, imad_rate)
        timing[key] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                       "plain_shape": {**shape, "B": cut}, "bound_ms": bound, "bound_by": bound_by, "dense_bound_ms": dense,
                       "max_abs_err": e}
        del x
        torch.cuda.empty_cache()
    return timing


# (field, t) beyond the tree's: the 12-word base fields, and t = 17, the
# last entry of the reference's round table (blaze_tpu/hash/params.py)
WIDE_POSEIDON = (("bls12_381_fq", 3), ("bls12_377_fq", 3), ("bn254_fr", 17),
                 ("bls12_381_fq", 17))


def phase_poseidon_parity(imad_rate: float, seed: int, device):
    """K10 against its plain version, exact, on the three scalar fields (t =
    9 and 12, with and without convert_in, B = 1 and 1000; the sparse
    schedule, and on bls12_381_fr also the dense rounds of an
    instance whose MDS has a singular lower-right block), the multi-p REDC
    twin against the plain redc_sum on edge inputs; then the WIDE_POSEIDON
    instances (B = 1 and 300) and their REDC twin; then the main shapes."""
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import PoseidonKernels, generate_params
    from blaze_tpu_torch.hash.kernels import sum_products, sum_products_plain

    err = 0
    for field in NTT_FIELDS:
        spec = FIELDS[field]
        checked = []
        for t in (9, 12):
            instances = [generate_params(spec, t)]
            if field == POSEIDON_FIELD:
                instances.append(singular_block(instances[0]))
            for params in instances:
                k = PoseidonKernels.for_params(params)
                for B in (1, 1000):
                    x = near_p_states(spec, t, B, seed + t + B, device)
                    for conv in (False, True):
                        e = max_abs_err(k.permute_lm(x, convert_in=conv),
                                        k.permute_lm_plain(x, convert_in=conv))
                        checked.append({"kernel": "poseidon_perm", "t": t, "B": B,
                                        "convert_in": conv, "sparse": k.sparse,
                                        "max_abs_err": e})
            a, c = redc_edge_inputs(spec, t, seed + t, device)
            e = max_abs_err(sum_products(spec, a, c), sum_products_plain(spec, a, c))
            checked.append({"kernel": "redc_sum", "t": t, "B": a.shape[2], "max_abs_err": e})
        torch.cuda.synchronize()
        emit({"phase": "poseidon_parity", "field": field, "shape": "small", "cases": checked})
        if any(c["max_abs_err"] for c in checked):
            raise AssertionError(f"{field}: K10 or the REDC twin differs from its plain version")
        if not any(c.get("sparse") for c in checked):
            raise AssertionError(f"{field}: no instance took the sparse schedule")
        err = max([err] + [c["max_abs_err"] for c in checked if c["kernel"] == "poseidon_perm"])
    checked = []
    for field, t in WIDE_POSEIDON:
        spec = FIELDS[field]
        k = PoseidonKernels.for_params(generate_params(spec, t))
        for B in (1, 300):
            x = near_p_states(spec, t, B, seed + t + B, device)
            for conv in (False, True):
                e = max_abs_err(k.permute_lm(x, convert_in=conv),
                                k.permute_lm_plain(x, convert_in=conv))
                checked.append({"kernel": "poseidon_perm", "field": field, "W": spec.nwords,
                                "t": t, "B": B, "convert_in": conv, "sparse": k.sparse,
                                "max_abs_err": e})
        a, c = redc_edge_inputs(spec, t, seed + t, device)
        e = max_abs_err(sum_products(spec, a, c), sum_products_plain(spec, a, c))
        checked.append({"kernel": "redc_sum", "field": field, "W": spec.nwords, "t": t,
                        "B": a.shape[2], "max_abs_err": e})
    torch.cuda.synchronize()
    emit({"phase": "poseidon_parity", "shape": "12-word fields and t = 17", "cases": checked})
    if any(c["max_abs_err"] for c in checked):
        raise AssertionError("K10 or the REDC twin differs from its plain version at W = 12 "
                             "or t = 17")
    err = max([err] + [c["max_abs_err"] for c in checked if c["kernel"] == "poseidon_perm"])
    timing = poseidon_main_timing(imad_rate, seed, device)
    emit({"phase": "poseidon_parity", "field": POSEIDON_FIELD,
          "shape": "main path (height 9)", "kernels": timing})
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("K10 differs from its plain version at the main shapes")
    return {"poseidon_perm": max([err] + [t["max_abs_err"] for t in timing.values()])}, timing


def parse_records(raw: bytes):
    """64 B result records -> (hashes (n, 32) uint8, layer ids, hash ids)."""
    import numpy as np

    rec = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 64)
    meta = np.ascontiguousarray(rec[:, 32:40]).view("<u8")[:, 0]
    return rec[:, :32], meta >> np.uint64(30), meta & np.uint64(0x3FFFFFFF)


def tree_ids(height: int):
    """The (layer id, hash id) arrays a height's record stream must carry."""
    import numpy as np

    sizes = [8 ** (height - 1 - l) for l in range(height)]
    return (np.repeat(np.arange(height, dtype=np.uint64), sizes),
            np.concatenate([np.arange(n, dtype=np.uint64) for n in sizes]))


def phase_poseidon_h4(seed: int) -> dict:
    """The reference's own contract (integration_poseidon.rs:23,151-155):
    height 4, 512 leaves of 11 wire elements, 585 nodes, every node against
    the oracle; then TREE_D at height 4.  Returns the launch counts."""
    import numpy as np

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import LEAF_ARITY, TreeMode, generate_params, num_tree_nodes
    from blaze_tpu_torch.oracle.poseidon_ref import merkle_tree_ref, poseidon_hash_ref
    from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

    spec = FIELDS[POSEIDON_FIELD]
    h, n, nodes = 4, 512, num_tree_nodes(4)
    leaf_p, node_p = generate_params(spec, LEAF_ARITY + 1), generate_params(spec, 9)
    rng = random.Random(seed)
    total = {}
    for mode in (TreeMode.TREE_C, TreeMode.TREE_D):
        if mode == TreeMode.TREE_C:
            cols = [[rng.randrange(spec.p) for _ in range(LEAF_ARITY)] for _ in range(n)]
            elems = [v for c in cols for v in c]
            t0 = time.perf_counter()
            layers = merkle_tree_ref(leaf_p, node_p, cols, h)
        else:
            leaves = [rng.randrange(spec.p) for _ in range(n)]
            elems = leaves
            t0 = time.perf_counter()
            layers = [leaves]
            while len(layers[-1]) > 1:
                prev = layers[-1]
                layers.append([poseidon_hash_ref(node_p, prev[i:i + 8])
                               for i in range(0, len(prev), 8)])
        oracle_s = time.perf_counter() - t0
        raw = b"".join(v.to_bytes(spec.nbytes, "little") for v in elems)
        _build.reset_launches()
        cl = PoseidonClient(POSEIDON_FIELD)
        cl.initialize(PoseidonInitializeParameters(tree_height=h, tree_mode=mode))
        cl.set_data(raw)
        t0 = time.perf_counter()
        cl.start_process()
        cl.wait_result()
        build_s = time.perf_counter() - t0
        recs = cl.result(expected_count=nodes)
        rawres = cl.result_raw()
        counts = dict(_build.LAUNCHES)
        want = [(v, lid, hid) for lid, l in enumerate(layers) for hid, v in enumerate(l)]
        got = [(int.from_bytes(r.hash, "little"), r.layer_id, r.hash_id) for r in recs]
        hashes, lids, hids = parse_records(rawres)
        parsed = [(int.from_bytes(hb.tobytes(), "little"), int(l), int(i))
                  for hb, l, i in zip(hashes, lids, hids)]
        info = {"records": len(recs), "oracle": "match" if got == want else "MISMATCH",
                "raw_parses_back": parsed == got, "build_s": build_s,
                "oracle_s": oracle_s, "launches": counts}
        emit({"phase": f"poseidon_h4_{mode.name.lower()}", **info})
        if got != want or parsed != got:
            raise AssertionError(f"poseidon height 4 {mode.name}: differs from the oracle")
        check_launches(f"poseidon_h4_{mode.name}", counts, ("poseidon_perm", "mont_mul"))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_poseidon_h9(seed: int, height: int = 9) -> dict:
    """The full-size tree: height 9 on bls12_381_fr, 8^8 = 2^24 leaves of 11
    elements (5.5 GiB of wire bytes from seeded numpy).  set_data once, two
    builds (the second on the resident columns), result_raw timed; sampled
    oracle checks.  Returns the launch counts."""
    import numpy as np
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import LEAF_ARITY, generate_params, num_tree_nodes
    from blaze_tpu_torch.oracle.poseidon_ref import poseidon_hash_ref
    from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

    spec = FIELDS[POSEIDON_FIELD]
    h = height
    n = 8 ** (h - 1)
    t0 = time.perf_counter()
    elems = host_vector(LEAF_ARITY * n, seed)          # canonical, < 2^254 < p
    gen_s = time.perf_counter() - t0
    wire = memoryview(elems).cast("B")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    cl = PoseidonClient(POSEIDON_FIELD)
    cl.initialize(PoseidonInitializeParameters(tree_height=h))
    t0 = time.perf_counter()
    cl.set_data(wire)
    set_s = time.perf_counter() - t0
    builds = []
    raws = []
    for i in range(2):
        t0 = time.perf_counter()
        cl.start_process()
        cl.wait_result()
        t1 = time.perf_counter()
        raws.append(cl.result_raw())
        t2 = time.perf_counter()
        builds.append({"start_to_wait_s": t1 - t0, "leaves_per_s": n / (t1 - t0),
                       "stage_s": cl.get_api()["stage_s"] if i == 0 else 0.0,
                       "result_raw_s": t2 - t1})
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches("poseidon_h9", counts, ("poseidon_perm", "mont_mul"))

    raw = raws[0]
    nodes = num_tree_nodes(h)
    hashes, lids, hids = parse_records(raw)
    want_l, want_h = tree_ids(h)
    ids_ok = bool(np.array_equal(lids, want_l) and np.array_equal(hids, want_h))
    same = raws[0] == raws[1]
    raws = None
    leaf_p, node_p = generate_params(spec, LEAF_ARITY + 1), generate_params(spec, 9)
    starts = np.concatenate([[0], np.cumsum([8 ** (h - 1 - l) for l in range(h)])])
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    bad = []
    idx = rng.choice(n, min(n, 256), replace=False)
    for i in idx:
        col = word_ints(elems[LEAF_ARITY * i: LEAF_ARITY * (i + 1)])
        if poseidon_hash_ref(leaf_p, col) != int.from_bytes(hashes[i].tobytes(), "little"):
            bad.append((0, int(i)))
    checked = {0: len(idx)}
    root_ok = False
    for l in range(1, h):
        size = 8 ** (h - 1 - l)
        sample = range(size) if size <= 64 else rng.choice(size, 64, replace=False)
        for j in sample:
            kids = [int.from_bytes(hashes[starts[l - 1] + 8 * j + c].tobytes(), "little")
                    for c in range(8)]
            ok = poseidon_hash_ref(node_p, kids) == int.from_bytes(
                hashes[starts[l] + j].tobytes(), "little")
            if not ok:
                bad.append((l, int(j)))
            if l == h - 1:
                root_ok = ok
        checked[l] = len(sample)
    oracle_s = time.perf_counter() - t0
    info = {"height": h, "leaves": n, "elements": LEAF_ARITY * n,
            "wire_gib": LEAF_ARITY * n * spec.nbytes / 2**30, "input_gen_s": gen_s,
            "set_data_s": set_s, "builds": builds, "records": len(hashes),
            "record_count_ok": len(hashes) == nodes, "ids_ok": ids_ok,
            "second_build_equal": same, "sampled_per_layer": checked,
            "sampled_mismatches": bad, "root_ok": root_ok, "oracle_s": oracle_s,
            "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    emit({"phase": "poseidon_h9", **info})
    if bad or not (info["record_count_ok"] and ids_ok and same and root_ok):
        raise AssertionError("poseidon height 9: a check failed")
    if counts["poseidon_perm"] != 2 * h:
        raise AssertionError(f"poseidon height 9: {counts['poseidon_perm']} K10 launches "
                             f"for two builds, want {2 * h}")
    return counts


def phase_poseidon_stream(seed: int, height: int = 7, stream_leaves: int = 1 << 14) -> dict:
    """Feed-while-hashing (integration_poseidon.rs:81-119): a feeder thread
    calls set_data in chunks while a drainer thread calls drain_stream; leaf
    records must arrive before the last feed, and the closed tree must equal
    a staged build of the same elements.  Returns the launch counts."""
    import threading

    import numpy as np

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.hash import LEAF_ARITY, num_tree_nodes
    from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

    n = 8 ** (height - 1)
    elems = host_vector(LEAF_ARITY * n, seed + 1)
    _build.reset_launches()
    cl = PoseidonClient(POSEIDON_FIELD)
    cl.initialize(PoseidonInitializeParameters(tree_height=height,
                                               stream_leaves=stream_leaves))
    drained, early = [], [0]
    feed_done = threading.Event()
    step = LEAF_ARITY * max(1, stream_leaves // 4)         # 4 feeds per streamed block

    def feeder():
        for i in range(0, elems.shape[0], step):
            cl.set_data(elems[i:i + step].tobytes())
            time.sleep(0.005)
        feed_done.set()

    def drainer():
        while not feed_done.is_set():
            got = cl.drain_stream()
            if not feed_done.is_set():
                early[0] += len(got)
            drained.extend(got)
            time.sleep(0.002)
        drained.extend(cl.drain_stream())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=feeder), threading.Thread(target=drainer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("poseidon stream: feeder or drainer did not finish")
    cl.start_process()
    cl.wait_result()
    stream_s = time.perf_counter() - t0
    raw = cl.result_raw()
    counts = dict(_build.LAUNCHES)
    check_launches("poseidon_stream", counts, ("poseidon_perm", "mont_mul"))

    ref = PoseidonClient(POSEIDON_FIELD)
    ref.initialize(PoseidonInitializeParameters(tree_height=height))
    ref.set_data(elems.tobytes())
    ref.start_process()
    ref.wait_result()
    want = ref.result_raw()
    hashes, _, _ = parse_records(want)
    leaf_ok = (len(drained) == n
               and [r.hash_id for r in drained] == list(range(n))
               and b"".join(r.hash for r in drained) == hashes[:n].tobytes())
    info = {"height": height, "leaves": n, "stream_leaves": stream_leaves,
            "feed_calls": -(-elems.shape[0] // step), "drained": len(drained),
            "drained_before_last_feed": early[0], "drained_equal_staged_leaves": leaf_ok,
            "records": len(raw) // 64, "equal_staged": raw == want,
            "feed_to_wait_s": stream_s, "launches": counts}
    emit({"phase": "poseidon_stream", **info})
    if not (leaf_ok and raw == want and early[0] > 0
            and len(raw) // 64 == num_tree_nodes(height)):
        raise AssertionError("poseidon stream: a check failed")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree of the package (e.g. the parent commit unpacked "
                         "under build/): also run the MSM 2^24 phase from it and from "
                         "this tree, each run in a fresh process, in alternating pairs, "
                         "for the end-to-end comparison")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "blaze_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: blaze_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    dev = torch.device("cuda")
    seconds = {}

    def timed_phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    card, imad_rate = timed_phase("device_and_build", phase_device)
    errs, timing = timed_phase("msm_parity", phase_parity, imad_rate, dev)
    launches = timed_phase("msm_clients", phase_main_path, args.seed)
    for k, v in timed_phase("msm_2^24", phase_msm_2e24, args.seed).items():
        launches[k] += v
    if args.parent:
        timed_phase("msm_2^24_compare", phase_msm_2e24_compare, args.parent, args.seed)
    timed_phase("msm_2^19_profile", profile_single_chunk, args.seed)
    ntt_errs, ntt_timing = timed_phase("ntt_parity", phase_ntt_parity, imad_rate, args.seed, dev)
    errs.update(ntt_errs)
    timing.update(ntt_timing)
    for counts in (timed_phase("ntt_2^27", phase_ntt_2e27, args.seed),
                   timed_phase("ntt_2^16_2^20_goldens", phase_ntt_small, args.seed)):
        for k, v in counts.items():
            launches[k] += v
    dist_errs, dist_counts, _ = timed_phase("dist", phase_dist, imad_rate, args.seed)
    for k, v in dist_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in dist_counts.items():
        launches[k] += v
    for k, v in timed_phase("pipeline", phase_pipeline, args.seed).items():
        launches[k] += v
    pos_errs, pos_timing = timed_phase("poseidon_parity", phase_poseidon_parity, imad_rate,
                                       args.seed, dev)
    errs.update(pos_errs)
    timing.update(pos_timing)
    for counts in (timed_phase("poseidon_h4", phase_poseidon_h4, args.seed),
                   timed_phase("poseidon_h9", phase_poseidon_h9, args.seed),
                   timed_phase("poseidon_stream", phase_poseidon_stream, args.seed)):
        for k, v in counts.items():
            launches[k] += v
    emit({"phase_seconds": seconds})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": None, "threads_per_lane": threads_per_lane(name),
         **({"chain_bound_ms": timing[name]["chain_bound_ms"]}
            if "chain_bound_ms" in timing[name] else {})}
        for name, (src, rep) in KERNELS.items()
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
