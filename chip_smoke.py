#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (blaze_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card (nvidia-smi name and power limit, CUDA, capability)
   and its row of blaze_tpu_torch.bench.profile's SOL_TABLE, held against
   the max SM clock nvidia-smi reads and the SMs and shared memory torch
   reads (the bounds below come from that row), then the kernels built
   from csrc/ with nvcc (seconds, registers, stack, spills) and the
   local-memory loads and stores (LDL, STL) in the EC, NTT and Poseidon
   kernels' SASS, with the opcode mix of K2 (both forms), K3, K4 (both forms), K7 (at K
   = 512, W = 8 and 12) and K10 (cuobjdump);
2. kernel parity: K1-K6 against their plain PyTorch versions on the card,
   exact, on BN254, BLS12-377, BLS12-381 and BN254's G2 (K2-K6's F_p2
   instances, no K1) at small shapes (K2 signed and unsigned) and at
   ragged shapes: K2 and K4 at lane counts B = 1, 33,
   1000 (C = 1; K4 also over rows that hold identities), K3 at the same
   lane counts (identities as either operand, p = q), K5 at B = 1, 33,
   1000 (k 15), K6 at Wn = 1, 2, 20 (c 13) and, on the 12-word curves, at
   Wn = 128 (c 2, past 48 KB of shared memory), on G2 at Wn = 40 (c 2);
   then at the main path's
   shapes for BLS12-381 with each kernel's time (CUDA events), its plain
   version's time and its bound: K2 at a 2^19 chunk (C 512, B 16384; its
   rows and its gathered form) and a streamed 2^18 chunk (B 8192), K3 at a lane-prefix round (B 16384) and
   at the window sums' accumulation (B 16), K4's five rounds at a 2^19
   chunk (its first pass both in its gathered form, reading the bucket
   sum in place through the bounds, and in its rows form on the rows made
   from the same operands), K5 at (B 16, k 16) and K6 at (Wn 16, c 16) and (Wn 20, c 13);
   the same for BN254 at the 8x precompute mode's chunk as MSM.plan
   makes it (G = 2 windows: K2 at C 512, B 16384, gathered from N 2^22;
   K3 at B 16384 and 2; K4's first pass at C 256, B 1024 in both forms
   and its later rounds) and K5 at k 32 over a 2^20 block of precompute_resident;
   the same for BN254's G2 at the G2 cell's chunk (a 2^24 MSM: K2 at C
   512, B 16384, gathered from N 2^19; K4's first pass at C 256 x 8192),
   timed and bounded under the F_p2 keys (scan_g2_gathered, ...: an F_p2
   product three unreduced F_p products and two REDCs);
   K3, K5 and K6 beside their chain bound (the products on the team's
   critical path times one product's latency, timed on one thread:
   blz_product_chain); then KF (the Field's add, sub, neg, double and
   canon, fields/elementwise.py) against its plain version, exact, at W = 8
   and 12 and 1, 33, 1000 and 2^19 x 16 elements, with its time and bytes
   bound at the chunk's canon and at 2^23 elements;
3. main path, streamed client: MSMClient(MSMInit("bls12_381")) over 2^20
   points in the reference's order initialize -> start_process -> four
   set_data chunks of wire bytes -> result();
4. main path, single-chunk client: 2^19 points, set_data -> start_process
   -> wait_result -> result(); then the 2^19 chunk on one engine run
   eagerly (`_fused_chunk`) and as a CUDA graph (the capture's warm-up,
   then five replays): the same words, each replay's launches exactly one
   chunk's (K2, K4's gathered form, K4 x4, K5, K3 x13, KF x5, no K1), the
   eager and replayed times and the graph pool's bytes;
4b. the headline shape (bench.py:10): 2^24 points resident, set_data once
   -> start_process -> wait_result -> result(), 32 chunks of 2^19, their
   window sums accumulated on K3 and folded on K6 (the fold's seconds
   printed), then five more start_process -> wait_result on the resident
   operands (best, median and spread; each result's bytes the first's).
   Each chunk is one CUDA graph replay but the first (the capture's
   warm-up).  Then the G2 cell's MSM: 2^24 BN254 G2 bases (256 k P2 of
   zkbench/reference/bn254_g2.py, tiled) resident, one MSM.__call__ to
   capture, the counters zeroed, one more held to the reference in affine
   form, its launches printed: only the F_p2 instances of K2-K6, K2 and
   K4's gathered form once a chunk, K6 once.  Phases 3, 4 and 4b each
   launch K6 exactly once.  After it,
   in a fresh process, the eager 2^19 chunk (its device operations) and
   one warm 2^19 single-chunk MSM, its chunk a graph replay, run under
   torch.profiler (device operations, busy time, idle share; the trace
   holds a replayed graph's kernels).
   Phases 3, 4 and 4b use 256 points of the order-r subgroup tiled and
   distinct scalars drawn uniformly from [0, r); the expected value is the
   oracle MSM of the 256 points with each point's coefficient sum mod r,
   and the result bytes must match it after z-normalisation.
5. NTT kernel parity: K7-K9 against their plain versions, exact, on
   bn254_fr, bls12_377_fr, bls12_381_fr and (the W = 12 builds)
   bls12_377_fq at small shapes (K7 through
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
   K8, no K1) and then through run_batches (the next batch's NTT on a side
   stream while the host queues this batch's MSM); the results must be distinct,
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
   versions, whole, on the four NTT fields, then at the 2^27
   four-step's maps (K7 at each level of the 2^13 column and 2^14 row
   sub-plans, K9 at their twiddles and at the inter-pass twiddle) with
   times and bounds, each held against its plain version on a cut;
   DistributedMSM at 2^24 on BLS12-381 (256 subgroup points tiled,
   distinct full-width scalars) equal to the single-card MSM.__call__
   (run in turns with it: sharded, single, single, sharded) and the
   oracle; DistributedNTT at 2^27 on bls12_381_fr (logn1 13)
   whose spectral_to_natural equals FusedNTT.ntt word for word and
   whose intt comes back to the input (launches K7 x4, K9 x3, no K8; one
   transform under torch.profiler: K7 x4, K9 x3 and nothing else);
   ProofPipeline(mesh={dp: 1, sp: 1}).run_dist at (2^27, 2^24) with
   full-width scalars against its geometric oracle.  Each prints wall
   seconds, device milliseconds (CUDA events), launches per kernel and
   peak memory; launch counts are zeroed before each run;
7d. (run after 7, before 7c) ntt_377fq_2^27: NTTs over the 12-word
   bls12_377_fq (48-byte elements, BW6-761's scalar field) at the
   reference's 2^27: K7-K9's
   W = 12 builds at the 2^27 plan's shapes with times and bounds, each
   held against its plain version on a cut; one warm FusedNTT transform
   (CUDA events) held by its inverse and by the input polynomial evaluated
   at W^k at 8 indices (no NTT kernel), and split in a fresh child's
   profile (K7 x3 and K9 x2, nothing else; the 2^16 plan's K7 x2 and K8
   x1); NTTClient forward and inverse on two 6 GiB vectors, each output
   equal to the plan's and each inverse back to its input bytes, with
   set_data, start->wait and result seconds and the peak memory; the
   client at 2^16 (K7 x2, K8 x1) against a host NTT in Python ints;
   DistributedNTT at 2^24 on a mesh of one against FusedNTT, and back; a
   plan past 7 levels (2^22 at klog 3) against the klog-9 plan.  Launch
   counts are zeroed before each run and must be exactly the plan's;
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
   4b, 6, 7, 9, 10 and 11, each serial batch of 7b and each run of 7c and 7d,
   and read just after; every kernel of the run's path must have launched (K10 nine
   times per height-9 build; K2 once, K4's gathered form once and K4 four
   times per 2^19 chunk at 2^24; K6 once per MSM).
11b. the probes of experiments/ (blaze_tpu_torch.experiments, E1-E5) at
   a cut size (2^16 lanes, chains of at most 9 steps): every lane of every
   body (the field product's parts on csrc/probe_chain.cu, the product
   whose REDC runs on the int8 tensor cores and its two matrix products on
   csrc/mont_tc.cu, E5's mixed-add body on K2's team of six) against its
   plain version, limit 0, with one line of times; one line of E2's
   product forms (K0's mont beside mont_hi, the lo / hi form, and the
   other forms, at W = 8 and 12): per product the step loop's FMA-pipe
   slots, ALU-pipe operations and instructions, registers, ns per product
   and one product's latency on one warp; launch counts zeroed
   before and read after (probe_chain and mont_tc must launch); then
   probe_chain (E2's mont body, W = 12, M = 9) and mont_tc (E1's one
   product, W = 12) at 2^16 timed beside their plain versions and bounds;
12. the seconds each phase took, then the kernels line (K1, KF, K2-K10,
   K2-K6's F_p2 instances (scan_g2_mixed ... fold_g2_horner) at the G2
   cell's shapes,
   K7-K9's W = 12 builds as ntt_base_w12, mul_lm_w12, twiddle_mul_w12,
   their times at the W = 12 2^27 plan's shapes, and the probe kernels
   probe_chain and mont_tc, their launches those of phase 11b): launches
   in those runs, parity error, times, bounds, threads per lane, and K3's,
   K5's and K6's chain bound.  A kernel's `ms` is CUDA events around
   repeated launches queued behind a spin of the card, so a kernel shorter
   than its launch from Python (K1, K3, K8) is not timed at the host's
   pace.
Every torch.profiler measurement (the 2^19 MSM profile, the NTT splits of
phases 5, 7c and 7d, the pipeline's trace) runs early in a child process of its
own (`fresh`): on the card's machine the profiler drops more of the card's
events the older the process is, from about 40 s on (PERF.md §7).  A trace
that holds fewer events of a kernel than its launch counter rose by in the
window fails the phase (trace.TraceLost).

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi prints them.  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# launch-counter name -> (source, the TPU kernel's pallas_call it replaces);
# in PERF.md's table these are K1, KF, K2-K10, then E2-E5 and E1, then K2-K6
# on F_p2, in this order
KERNELS = {
    "mont_mul": ("blaze_tpu_torch/csrc/montmul.cu", "blaze_tpu/fields/mxu.py:250"),
    # KF, the port's own kernel: it stands for XLA's fused elementwise Field
    # ops (Field._cond_sub_p / add / sub / neg / double), no pallas_call
    "field_ew": ("blaze_tpu_torch/csrc/field_ew.cu", "blaze_tpu/fields/mont.py:149"),
    "scan_mixed": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:248"),
    # K2's gathered form (the MSM's): the same kernel reading through the sort
    "scan_gathered": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:248"),
    "ec_add": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:563"),
    "reduce_cols": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:343"),
    # K4's gathered form (the MSM's): the same kernel reading the bucket sum
    # in place through the bounds
    "reduce_buckets": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:343"),
    "dbl_n": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:508"),
    "fold_horner": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:444"),
    "ntt_base": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:102"),
    "mul_lm": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:168"),
    "twiddle_mul": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:252"),
    "poseidon_perm": ("blaze_tpu_torch/csrc/poseidon_kernels.cu",
                      "blaze_tpu/hash/kernels.py:207"),
    # K7-K9's W = 12 builds (bls12_377_fq), counted apart
    "ntt_base_w12": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:102"),
    "mul_lm_w12": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:168"),
    "twiddle_mul_w12": ("blaze_tpu_torch/csrc/ntt_kernels.cu", "blaze_tpu/ntt/kernels.py:252"),
    # E1-E5: the pallas_calls of the probe scripts under experiments/
    "probe_chain": ("blaze_tpu_torch/csrc/probe_chain.cu",
                    "experiments/redc_probe.py:66, experiments/vpu_mul_probe.py:81, "
                    "experiments/mul_kernel_bench.py:83, experiments/kernel_variants.py:46"),
    "mont_tc": ("blaze_tpu_torch/csrc/mont_tc.cu", "experiments/pallas_mul.py:146"),
    # K2-K6's F_p2 instances (BN254's G2), counted apart; the JAX package has
    # no G2, so each replaces its G1 kernel's pallas_call over F_p2
    "scan_g2_mixed": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu", "blaze_tpu/curves/kernels.py:248"),
    "scan_g2_gathered": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu",
                         "blaze_tpu/curves/kernels.py:248"),
    "ec_g2_add": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu", "blaze_tpu/curves/kernels.py:563"),
    "reduce_g2_cols": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu",
                       "blaze_tpu/curves/kernels.py:343"),
    "reduce_g2_buckets": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu",
                          "blaze_tpu/curves/kernels.py:343"),
    "dbl_g2_n": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu", "blaze_tpu/curves/kernels.py:508"),
    "fold_g2_horner": ("blaze_tpu_torch/csrc/ec_kernels_g2.cu",
                       "blaze_tpu/curves/kernels.py:444"),
}
SCALAR_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")
WIDE_NTT_FIELD = "bls12_377_fq"       # 12 words, 2-adicity 46: BW6-761's scalar field
NTT_FIELDS = (*SCALAR_FIELDS, WIDE_NTT_FIELD)


def threads_per_lane(name: str) -> int:
    """Threads that compute one lane of a kernel, as its built library
    reports it (blz_threads_per_lane of the kernel's source; a W = 12 build
    as its kernel)."""
    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import kernel_of

    return _build.threads_per_lane(Path(KERNELS[name][0]).stem, kernel_of(name))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


FRESH_TIMEOUT_S = 600


def fresh(fn_name: str, *args):
    """chip_smoke.<fn_name>(*args) in a fresh child process on the same card:
    its lines are printed here, and what it returns (JSON) is returned.  On
    the card's machine torch.profiler drops more of the card's events the
    older the process is, from about 40 s on (PERF.md §7), so each profiled
    measurement runs early in a process of its own.  Raises if the child
    fails."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke as cs\n"
            f"out = cs.{fn_name}(*json.loads(sys.argv[1]))\n"
            "print('RESULT ' + json.dumps(out), flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(args)], cwd=ROOT,
                         capture_output=True, text=True, timeout=FRESH_TIMEOUT_S)
    result = None
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        else:
            print(line, flush=True)
    if out.returncode != 0:
        raise AssertionError(f"{fn_name} in a fresh process failed:\n{out.stderr[-4000:]}")
    return result


# ------------------------------------------------------------------ inputs
def tiled_instance(spec, n: int, seed: int, expected: bool = True):
    """Wire bytes of n points (subgroup_msm_instance's 256 points tiled)
    and n distinct random scalars, and the expected affine MSM."""
    import numpy as np

    from blaze_tpu_torch.curves import encode_affine_points, encode_scalars
    from blaze_tpu_torch.oracle.gen import points_to_affine_words, subgroup_msm_instance

    upoints, scal, want = subgroup_msm_instance(spec, n, seed, expected)
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
def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs()
    return int(d.max()) if d.numel() else 0


# ------------------------------------------------------------ phase 1
# a kernel's name: lower case and `_`, and on G2 one `g2_` inside it
# (scan_g2_gathered_kernel); the digits before it are its mangled length
KERNEL_NAME = re.compile(r"([a-z_]+(?:g2_[a-z_]+)?_kernel)ILi(\d+)E(?:Li(\d+)E)?(?:Lb(\d))?")


def kernel_key(mangled: str):
    """'scan_mixed_kernel<12>s' for a mangled kernel name (s: signed; g:
    K2's gathered form, 'scan_mixed_kernel<12>g'; b: K4's,
    'reduce_cols_kernel<12>b'; G2's 'scan_g2_gathered_kernel<8>g'),
    'ntt_base_kernel<8,9>' for two int
    parameters, or None for other functions."""
    m = KERNEL_NAME.search(mangled)
    if not m:
        return None
    args = m.group(2) + ("," + m.group(3) if m.group(3) else "")
    return (f"{m.group(1)}<{args}>" + ("s" if m.group(4) == "1" else "")
            + ("g" if "scan_gathered_fetch" in mangled else "")
            + ("b" if "reduce_buckets_fetch" in mangled else ""))


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


def sass_summary(libs, mix_of=("scan_mixed_kernel<12>", "scan_mixed_kernel<12>g",
                              "ec_add_kernel<12>", "reduce_cols_kernel<12>",
                              "reduce_cols_kernel<12>b",
                              "ntt_base_kernel<8,9>", "ntt_base_kernel<12,9>",
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
    """The card's name and power limit, and its SOL_TABLE row (held against
    nvidia-smi and torch: bench.profile.check_card)."""
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import check_card, smi, speed_of_light

    card = smi("name,power.limit")
    sol = speed_of_light(torch.cuda.get_device_name(0))
    read = check_card(sol)
    build_s = _build.build_all()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(torch.cuda.get_device_capability(0)),
          **read, "imad_per_s": sol.imad_per_s, "hbm_bytes_per_s": sol.hbm_bytes_per_s,
          "build_s": build_s, "ptxas": ptxas_summary(_build.BUILD_LOG),
          "sass": sass_summary([_build._lib_path(n) for n in ("ec_kernels", "ntt_kernels",
                                                              "poseidon_kernels")])})
    return card, sol


# ------------------------------------------------------------ phase 2
def curve_inputs(spec, C: int, B: int, seed: int, device):
    """(C, 2W, B) affine Montgomery rows of oracle points (16 distinct,
    repeated; on G2 the plain reference's k P2) and a random sign row."""
    import torch

    from blaze_tpu_torch.curves import Curve
    from blaze_tpu_torch.oracle import ECOracle

    cv = Curve(spec)
    if spec.degree == 2:
        from zkbench.reference import bn254_g2

        pts = bn254_g2.subgroup_points(16, seed)
    else:
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


def kernel_cases(spec, C: int, B: int, seed: int, device, main: bool, G: int = 16):
    """(key, kernel, kernel call, plain call, shape) for K1-K6 on one curve's
    inputs: K2 at C rows of B lanes, K3 at B lanes, K4 at (C / 2, B / 2).
    At the main shapes (a chunk of G windows of c = 16, R = B / G lanes
    each) K4's first pass is instead the bucket sum's: its rows form on the
    rows `bucket_rows` makes (C 256 rows of 512 G lanes: G windows of 2^17
    bucket points, whatever R) of G windows' bounds of random 16-bit
    digits, with K2's lazy prefixes as emitted and lane prefix; and the
    cases add K4's gathered form on the same operands, read in place
    (reduce_buckets), K2 at the streamed chunk's lanes, K2's gathered form
    at the chunk (N = R C resident points read through G windows' sort of
    random 16-bit digits), K4's later rounds (keys reduce_buckets,
    scan_mixed_streamed, scan_gathered, reduce_cols_r2..r5) and, at G = 2
    (the 8x precompute mode's 32-bit slices), K5's 32 doublings over a 2^20
    block of precompute_resident (key dbl_n_precompute).  On G2 (F_p2
    coordinates) no K1 case: its product is K1 on F_p, BN254's."""
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
    if main:
        # the bucket sum's first pass at the chunk: G windows of R C points'
        # random 16-bit digits (2^16 buckets); its rows made for the rows form
        R, nb = B // G, 1 << 16
        gb = torch.Generator().manual_seed(seed + 1)
        bd = torch.randint(0, nb, (G, R * C), generator=gb).to(device)
        hist = torch.zeros((G, nb), dtype=torch.int64, device=device)
        hist.scatter_add_(1, bd, torch.ones_like(bd))
        bounds = torch.cumsum(hist, dim=-1) - 1
        lane_pre = emitted[-1].contiguous()
        red_rows = k.bucket_rows(emitted, lane_pre, bounds, C, R, nb)
        del bd, hist
    else:
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
         {"C": red_rows.shape[0], "B": red_rows.shape[2]}),
        ("dbl_n", lambda: k.dbl_n(pts, 16), lambda: k.dbl_n_plain(pts, 16),
         {"B": pts.shape[1], "k": 16}),
        ("fold_horner", lambda: k.fold_horner(ws, 16), lambda: k.fold_horner_plain(ws, 16),
         {"Wn": 16, "c": 16}),
    ]
    cases = [(c[0], *c) for c in cases if spec.degree == 1 or c[0] != "mont_mul"]
    if not main:
        cases.append(("scan_mixed", "scan_mixed", lambda: k.scan_mixed(rows_s),
                      lambda: k.scan_mixed_plain(rows_s), {"C": C, "B": B, "signed": 1}))
        return cases
    # K4's gathered form: the rows form's first pass, read in place
    cases.append(("reduce_buckets", "reduce_buckets",
                  lambda: k.reduce_buckets(emitted, lane_pre, bounds, C, R, nb),
                  lambda: k.reduce_buckets_plain(emitted, lane_pre, bounds, C, R, nb),
                  {"C": red_rows.shape[0], "B": red_rows.shape[2], "G": G, "buckets": nb}))
    # a streamed 2^18 chunk scans the same C rows over half the lanes; the
    # bucket sum's later reduce_cols rounds at a 2^19 chunk (G windows)
    half = rows[:, :, : B // 2].contiguous()
    cases.append(("scan_mixed_streamed", "scan_mixed", lambda: k.scan_mixed(half),
                  lambda: k.scan_mixed_plain(half), {"C": C, "B": B // 2}))
    N, R = (B // G) * C, B // G
    g = torch.Generator().manual_seed(seed)
    resident = aff[torch.randint(0, aff.shape[0], (N,), generator=g).to(device)]
    resident = resident.reshape(N, -1).t().contiguous()                  # (2W, N)
    digits = torch.randint(0, 1 << 16, (G, N), generator=g).to(device)
    order = torch.argsort(digits, dim=-1, stable=True)
    cases.append(("scan_gathered", "scan_gathered",
                  lambda: k.scan_gathered(resident, order, R, C),
                  lambda: k.scan_gathered_plain(resident, order, R, C),
                  {"C": C, "B": B, "N": N, "G": G}))
    cases.append(("fold_horner_c13", "fold_horner", lambda: k.fold_horner(ws20, 13),
                  lambda: k.fold_horner_plain(ws20, 13), {"Wn": 20, "c": 13}))
    # K3 at the accumulation of the chunks' window sums: one lane per window
    pw, qw = p[:, :G].contiguous(), q[:, :G].contiguous()
    cases.append(("ec_add_windows", "ec_add", lambda: k.add(pw, qw),
                  lambda: k.add_plain(pw, qw), {"B": G}))
    # the bucket sum's first reduce_cols pass is the reduce_cols case above
    # (C2 = 256 rows of G * R2 = G * 512 lanes); its later rounds:
    for r, (Cr, Br) in enumerate(((16, 32 * G), (4, 8 * G), (2, 4 * G), (4, G)), start=2):
        rr = emitted[:Cr, :, :Br].contiguous()
        cases.append((f"reduce_cols_r{r}", "reduce_cols", lambda rr=rr: k.reduce_cols(rr),
                      lambda rr=rr: k.reduce_cols_plain(rr), {"C": Cr, "B": Br}))
    if G == 2:
        # precompute_resident's block: 2^20 affine bases with Z = 1, each
        # doubled 32 times (one multiple's shift)
        blk = aff[torch.randint(0, aff.shape[0], (1 << 20,), generator=g).to(device)]
        one = cv.fq.one((1 << 20,), device).t()
        cur = torch.cat([blk.reshape(1 << 20, -1).t(), one]).contiguous()    # (3W, 2^20)
        cases.append(("dbl_n_precompute", "dbl_n", lambda: k.dbl_n(cur, 32),
                      lambda: k.dbl_n_plain(cur, 32), {"B": 1 << 20, "k": 32}))
    return cases


def ragged_cases(spec, seed: int, device):
    """(key, kernel, kernel call, plain call, shape) for K2 (unsigned and
    signed) and K4 at ragged lane counts B = 1, 33, 1000: one row (C = 1),
    and for K4 also four rows that hold identities, as the bucket sum's
    padding does; K3 at the same lane counts, identities as either operand
    and p = q; K5 at the same lane counts (k 15, identity lanes among
    them); K6 at Wn = 1, 2 and 20 (c 13) with identity windows, and on
    12-word curves at Wn = 128 (c 2) and on G2 at Wn = 40 (c 2), whose
    window sums take K6 past 48 KB of shared memory."""
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
    shapes += [(40, 2)] if spec.degree == 2 else []
    for Wn, c in shapes:
        ws = wins[:, :Wn].contiguous()
        cases.append(("fold_horner", "fold_horner", lambda ws=ws, c=c: k.fold_horner(ws, c),
                      lambda ws=ws, c=c: k.fold_horner_plain(ws, c), {"Wn": Wn, "c": c}))
    return cases


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def output_err(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(as_tuple(got), as_tuple(want)))


def small_parity(curve: str, errs: dict, device) -> None:
    """kernel_cases at (C 8, B 1024) and ragged_cases on `curve`, each
    kernel against its plain version (its error raised into `errs` under
    its launch-counter key); raises on any difference."""
    import torch

    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.curves.kernels import ECKernels

    spec = CURVES[curve]
    counter = ECKernels.for_curve(spec).counter
    checked, ragged = {}, []
    small = kernel_cases(spec, 8, 1024, 1, device, main=False)
    for i, (key, name, kern, plain, shape) in enumerate(small + ragged_cases(spec, 1, device)):
        e = output_err(kern(), plain())
        name = counter(name)
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


def phase_parity(sol, device):
    errs = {name: 0 for name in KERNELS}
    for curve in ("bn254", "bls12_377", "bls12_381", "bn254_g2"):
        small_parity(curve, errs, device)

    # the main path's shapes: BLS12-381 at a 2^19 chunk (16 windows of
    # c = 16, R = 1024 lanes, C = 512 rows; the bucket sum's first pass,
    # reduce_buckets and its rows form, is C = 256 rows of G * R2 = 8192
    # lanes)
    timing = main_shape_parity("bls12_381", 1 << 24, None, 2, sol, errs, device)
    emit({"phase": "parity", "curve": "bls12_381", "shape": "main path", "kernels": timing})
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("kernel differs from its plain version at the main shapes")
    # the 8x precompute mode's shapes: BN254 at a 2^22 chunk of 32-bit
    # slices (2 windows of c = 16, R = 8192 lanes, C = 512 rows; the bucket
    # sum's first pass, reduce_buckets and its rows form, is C = 256 rows of
    # 2 * 512 lanes)
    pre = main_shape_parity("bn254", 1 << 25, 32, 3, sol, errs, device)
    emit({"phase": "parity", "curve": "bn254", "shape": "main path, 8x precompute (G = 2)",
          "kernels": pre})
    if any(t["max_abs_err"] for t in pre.values()):
        raise AssertionError("kernel differs from its plain version at the 8x mode's shapes")
    # the G2 cell's shapes: BN254's G2 at a 2^19 chunk of a 2^24 MSM (16
    # windows, C 512, B 16384; the bucket sum's first pass C 256 x 8192),
    # the F_p2 instances timed under their own keys
    g2 = main_shape_parity("bn254_g2", 1 << 24, None, 4, sol, errs, device)
    emit({"phase": "parity", "curve": "bn254_g2", "shape": "main path (G2)", "kernels": g2})
    if any(t["max_abs_err"] for t in g2.values()):
        raise AssertionError("F_p2 kernel differs from its plain version at the G2 cell's shapes")
    timing.update(g2)
    return errs, timing


def main_shape_parity(curve: str, n: int, bits, seed: int, sol, errs: dict, device) -> dict:
    """kernel_cases at the chunk that MSM.plan makes of n points of
    `bits`-bit scalars (None: the field's) at c = 16 on `curve` (G windows,
    N points, C = N / R rows of G R lanes): each kernel against its plain
    version (its error raised into `errs`), with its time (CUDA events),
    its plain version's time and its bounds, by key (on G2 the F_p2
    instance's launch-counter key: scan_g2_gathered, ...)."""
    import torch

    from blaze_tpu_torch.bench.profile import (CHAINED, chain_bound_ms, cuda_ms,
                                               product_latency_us, work_bound_ms)
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.curves.kernels import ECKernels
    from blaze_tpu_torch.msm import MSM

    spec = CURVES[curve]
    W = spec.fq.nwords
    counter = ECKernels.for_curve(spec).counter
    G, N, R = MSM(Curve(spec)).plan(n, 16, bits)
    latency_us = product_latency_us(spec, device)
    emit({"phase": "product_latency", "curve": curve, "W": W * spec.degree, "us": latency_us})
    timing = {}
    for key, name, kern, plain, shape in kernel_cases(spec, -(-N // R), G * R, seed, device,
                                                      main=True, G=G):
        big = shape.get("C", 0) >= 256 or shape.get("B", 0) >= 1 << 20
        ms = cuda_ms(kern, 3 if big else 20)
        want, plain_ms = once_ms(plain)
        e = output_err(kern(), want)
        bound, bound_by = work_bound_ms(name, shape, W, sol, spec.degree)
        errs[counter(name)] = max(errs[counter(name)], e)
        timing[counter(key)] = t = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound, "bound_by": bound_by, "max_abs_err": e,
                                    "threads_per_lane": threads_per_lane(counter(name))}
        if name in CHAINED:
            t["chain_bound_ms"] = chain_bound_ms(name, shape, latency_us)
        del want
        torch.cuda.empty_cache()
    return timing


# KF at the main path's shape (the chunk's canon of its (16, 3, 12) window
# sums) and at 2^19 x 16 elements (a chunk's points times its windows)
EW_FIELDS = ("bn254_fq", "bls12_381_fq")          # W = 8 and 12
EW_SIZES = (1, 33, 1000, 1 << 23)
EW_CHUNK = 16 * 3                                  # the chunk's window sums' words


def phase_field_ew(sol, device):
    """KF against its plain version, exact, at W = 8 and 12 and EW_SIZES
    elements: every op on canonical values, canon on lazy values below 2p
    (half of them) with and without a carry word; then its time (CUDA
    events) beside its bytes bound and its plain version's time, at the
    chunk's canon (the main path's launch) and at 2^23 elements (add and
    canon).  Returns (max error, timing)."""
    import torch

    from blaze_tpu_torch.bench.profile import cuda_ms, work_bound_ms
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.fields.elementwise import OPS, field_ew, field_ew_plain
    from blaze_tpu_torch.fields.kernel_ops import (field_consts, normalize, words_i32,
                                                   words_u64)
    from blaze_tpu_torch.oracle.gen import rand_words

    err, checked, timing = 0, [], {}
    for field in EW_FIELDS:
        spec = FIELDS[field]
        W = spec.nwords
        p = words_u64(torch.as_tensor(field_consts(spec)[:W].view("int32"), device=device))
        for M in EW_SIZES:
            a, b = rand_words(spec, (M, W), M, device), rand_words(spec, (M, W), M + 1, device)
            coin = torch.randint(0, 2, (M, 1), device=device, dtype=torch.int32)
            lazy = torch.where(coin > 0, words_i32(normalize(words_u64(a) + p, 32)[0]), a)
            top = torch.randint(0, 2, (M,), device=device, dtype=torch.int32)
            e = 0
            for op in OPS:
                args = (lazy,) if op == "canon" else (a, b)
                e = max(e, max_abs_err(field_ew(spec, op, *args),
                                       field_ew_plain(spec, op, *args)))
            e = max(e, max_abs_err(field_ew(spec, "canon", lazy, top),
                                   field_ew_plain(spec, "canon", lazy, top)))
            checked.append({"field": field, "W": W, "M": M, "max_abs_err": e})
            err = max(err, e)
            del a, b, lazy, coin, top
        torch.cuda.empty_cache()
    spec = FIELDS["bls12_381_fq"]
    W = spec.nwords
    ws = rand_words(spec, (EW_CHUNK, W), 7, device)
    big = [rand_words(spec, (1 << 23, W), 8 + i, device) for i in range(2)]
    for key, op, args in (("field_ew", "canon", (ws,)), ("field_ew_2^23_add", "add", big),
                          ("field_ew_2^23_canon", "canon", big[:1])):
        M = args[0].shape[0]
        ms = cuda_ms(lambda: field_ew(spec, op, *args), 20)
        want, plain_ms = once_ms(lambda: field_ew_plain(spec, op, *args))
        e = max_abs_err(field_ew(spec, op, *args), want)
        err = max(err, e)
        shape = {"M": M, "operands": len(args)}
        bound, bound_by = work_bound_ms("field_ew", shape, W, sol)
        timing[key] = {"shape": {**shape, "op": op, "W": W}, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": bound_by, "max_abs_err": e,
                       "threads_per_lane": threads_per_lane("field_ew")}
        del want
    del big
    torch.cuda.empty_cache()
    emit({"phase": "field_ew_parity", "cases": checked, "kernels": timing})
    if err:
        raise AssertionError("KF differs from its plain version")
    return err, timing


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


def run_resident(n: int, seed: int, device=None, repeats: int = 0):
    """The headline shape (bench.py:10, bls12_381_msm_2^24): set_data once
    with every point and scalar, start_process -> wait_result -> result(),
    n / 2^19 chunks on the card and the window fold (`finalize`, timed) on
    tiled_instance(n, seed).  Then `repeats` more start_process ->
    wait_result on the resident operands (MSM.__call__, each chunk a graph
    replay), their best, median and spread; every result's bytes must be
    the first's.  info["launches"] holds the launch counters after
    the first run.  Returns (ok, info)."""
    import statistics

    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    t0 = time.perf_counter()
    praw, sraw, expected = tiled_instance(spec, n, seed)
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
    info = {"n": n, "chunks": -(-n // (1 << client.engine.config.chunk_log2)),
            "input_gen_s": gen_s, "set_data_s": t1 - t0, "start_to_wait_s": t2 - t1,
            "points_per_s": n / (t2 - t1), "fold_s": fold.get("s"),
            "chunks_queued_s": fold["enqueued"] - t1, "chunks_done_s": fold["done"] - t1,
            "launches": dict(_build.LAUNCHES),
            "graph_pool_bytes": client.engine.graph_pool_bytes,
            "graph_pool_gib": client.engine.graph_pool_bytes / 2**30}
    if repeats:
        client.engine.finalize = engine_finalize
        walls, same = [], True
        for _ in range(repeats):
            t0 = time.perf_counter()
            client.start_process()
            client.wait_result()
            walls.append(time.perf_counter() - t0)
            same = same and client.result().result == raw
        med = statistics.median(walls)
        ok = ok and same
        info.update({"repeat_start_to_wait_s": walls, "repeat_best_s": min(walls),
                     "repeat_median_s": med, "repeat_spread": (max(walls) - min(walls)) / med,
                     "repeat_points_per_s": n / min(walls), "repeats_equal_first": same})
    return ok, info


def device_profile(fn, what: str) -> dict:
    """fn() once under torch.profiler: the wall time, the device's busy time
    (the sum of the device events' times: kernels and copies on one
    stream) and idle share, their count, and the ones that took the most
    device time.  Raises TraceLost when the trace misses a kernel launch of
    the run (a CUDA graph's kernels are in the trace, each launch counted
    by its replay)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.trace import check_trace, dev_us, device_ops, traced_launches

    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    # the device's own events (kernels, copies): the aten ops above them
    # report the same time again as theirs
    kernels = device_ops(prof)
    check_trace(traced_launches((e.key, e.count) for e in kernels), launched, what)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms or None,
            "idle_share": (1 - busy_ms / (wall * 1e3)) if busy_ms else None,
            "device_ops": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3}
                    for e in top]}


def profile_single_chunk(seed: int, n: int = 1 << 19) -> dict:
    """The 2^19 chunk under torch.profiler, early in a fresh process: the
    eager `_fused_chunk` on the client's resident operands (its device
    operations, busy time and idle share), then one warm single-chunk MSM
    through the client (start_process -> wait_result), its chunk one graph
    replay (the same, with K6's fold).  Every kernel launch of each run
    must be in its trace."""
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.msm import default_window_bits
    from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES["bls12_381"]
    praw, sraw, _ = tiled_instance(spec, n, seed, expected=False)
    client = MSMClient(MSMInit(curve="bls12_381"))
    client.initialize(MSMParams(nof_elements=n))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    client.start_process()                 # the capture
    client.wait_result()
    client.result()
    eng = client.engine
    c = min(eng.config.window_bits, default_window_bits(n))
    eager = device_profile(lambda: eng._fused_chunk(client._points, client._scalars, c),
                           "msm_2^19_eager_chunk")

    def run():
        client.start_process()
        client.wait_result()

    replayed = device_profile(run, "msm_2^19_profile")
    client.result()
    info = {"n": n, "eager_chunk": eager, "replayed_msm": replayed,
            **{k: replayed[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                        "device_ops")}}
    emit({"phase": "msm_2^19_profile", **info})
    return info


# one replayed 2^19 chunk (BLS12-381, c 16, unsigned: R = 1024 lanes): K2
# once, K4's first pass in its gathered form and four rounds, K5 once, K3
# for the 10 Kogge-Stone rounds and the three group ops, KF for two
# negations (canon, neg) and the result's canon, and the chunk's five stage
# marks (trace.py)
CHUNK_LAUNCHES = {"scan_gathered": 1, "reduce_buckets": 1, "reduce_cols": 4, "dbl_n": 1,
                  "ec_add": 13,
                  "field_ew": 5, "mark_msm_sort": 1, "mark_msm_layout": 1,
                  "mark_msm_scan": 1, "mark_msm_bucket": 1, "mark_msm_stream": 1}


def phase_chunk_graph(seed: int, n: int = 1 << 19) -> dict:
    """The 2^19 chunk (BLS12-381) eager and as a CUDA graph on one engine:
    `_fused_chunk` run eagerly, the first `msm_partial` (the capture's
    warm-up, its result the chunk's) and five replays must give the same
    words; each replay launches CHUNK_LAUNCHES and no K1.  Prints the host
    and device times of an eager chunk and of a replay (CUDA events behind
    a spin), the capture's seconds and the graph pool's bytes."""
    import numpy as np
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import cuda_ms
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.msm import MSM, points_to_resident
    from blaze_tpu_torch.oracle.gen import points_to_affine_words, subgroup_msm_instance

    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    upoints, scal, _ = subgroup_msm_instance(spec, n, seed + 9, expected=False)
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).cuda()
    res = points_to_resident(cv, pts).repeat(1, n // len(upoints)).contiguous()
    sc = torch.from_numpy(scal.view(np.int32)).cuda().t().contiguous()
    eng = MSM(cv)
    c = 16
    eager, eager_ms = once_ms(lambda: eng._fused_chunk(res, sc, c))
    first, capture_ms = once_ms(lambda: eng.msm_partial(res, sc, c))
    walls, outs, counts = [], [], []
    for _ in range(5):
        _build.reset_launches()
        out, ms = once_ms(lambda: eng.msm_partial(res, sc, c))
        walls.append(ms)
        outs.append(out)
        counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
    eager_dev = cuda_ms(lambda: eng._fused_chunk(res, sc, c), 3)
    replay_dev = cuda_ms(lambda: eng.msm_partial(res, sc, c), 5)
    same = all(torch.equal(x, eager) for x in (first, *outs))
    info = {"n": n, "c": c, "graphs": len(eng._graphs),
            "graph_pool_bytes": eng.graph_pool_bytes,
            "graph_pool_gib": eng.graph_pool_bytes / 2**30,
            "eager_chunk_wall_ms": eager_ms, "eager_chunk_device_ms": eager_dev,
            "capture_wall_ms": capture_ms, "replay_wall_ms": walls,
            "replay_device_ms": replay_dev, "launches_per_replay": counts[0],
            "replays_equal_eager": same}
    emit({"phase": "msm_2^19_chunk_graph", **info})
    if not same or any(x != CHUNK_LAUNCHES for x in counts):
        raise AssertionError(f"chunk graph: equal to the eager chunk {same}, launches per "
                             f"replay {counts}, want {CHUNK_LAUNCHES}")
    return info


MSM_NEEDS = ("field_ew", "scan_gathered", "ec_add", "reduce_buckets", "reduce_cols", "dbl_n",
             "fold_horner")


def check_msm_launches(phase: str, counts: dict) -> None:
    """Every MSM kernel launched, and K6 exactly once: one fold per MSM."""
    check_launches(phase, counts, MSM_NEEDS)
    if counts["fold_horner"] != 1:
        raise AssertionError(f"{phase}: {counts['fold_horner']} K6 launches, want 1")


def phase_msm_2e24(seed: int, n: int = 1 << 24) -> dict:
    """MSM 2^24 resident through MSMClient against the oracle, then five more
    calls on the resident operands (best, median, spread); returns the
    first run's launch counts (every chunk runs K2 once, K4's gathered form
    once and its rows form four times, no K1 past set_data's)."""
    from blaze_tpu_torch import _build

    _build.reset_launches()
    ok, info = run_resident(n, seed + 2, repeats=5)
    counts = info["launches"]
    emit({"phase": "msm_2^24_resident", "oracle": "match" if ok else "MISMATCH", **info})
    if not ok:
        raise AssertionError("msm 2^24: result differs from the oracle")
    check_msm_launches("msm_2^24", counts)
    chunks = info["chunks"]
    if (counts["scan_gathered"] != chunks or counts["scan_mixed"]
            or counts["reduce_buckets"] != chunks or counts["reduce_cols"] != 4 * chunks):
        raise AssertionError(f"msm 2^24: {counts['scan_gathered']} gathered K2, "
                             f"{counts['scan_mixed']} rows-form K2, "
                             f"{counts['reduce_buckets']} gathered K4 and "
                             f"{counts['reduce_cols']} rows-form K4 launches for {chunks} chunks")
    return counts


G2_MSM_NEEDS = ("scan_g2_gathered", "ec_g2_add", "reduce_g2_buckets", "reduce_g2_cols",
                "dbl_g2_n", "fold_g2_horner")


def phase_g2_msm_2e24(seed: int, n: int = 1 << 24, U: int = 256) -> dict:
    """The G2 cell's MSM: n BN254 G2 bases (the plain reference's U points k
    P2, tiled) resident, n full-width scalars made on the card, MSM.__call__
    once to capture the chunk's graph, then the launch counters zeroed and
    one MSM, its result held to the reference's MSM of the class sums in
    affine form (each of the six F_p words below p, Z nonzero).  Every chunk
    runs the F_p2 K2 and K4 once each (K4's rows form four times) and no G1
    EC kernel; K6 once.  Returns the MSM's launch counts."""
    import numpy as np
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.fields import words_to_int
    from blaze_tpu_torch.msm import MSM, points_to_resident
    from zkbench.reference import bn254_g2

    spec = CURVES["bn254_g2"]
    cv, dev = Curve(spec), torch.device("cuda")
    pts = bn254_g2.subgroup_points(U, seed + 5)
    aff = cv.fq.from_int([c for pt in pts for c in pt], mont=False, device=dev)
    resident = points_to_resident(cv, aff.reshape(U, 2, -1)).repeat(1, n // U).contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    low = torch.randint(0, 1 << 16, (15, n), generator=g, dtype=torch.int32, device=dev)
    top = torch.randint(0, spec.fr.p >> 240, (1, n), generator=g, dtype=torch.int32,
                        device=dev)
    scal = torch.cat([low, top]).contiguous()
    msm = MSM(cv)
    msm(resident, scal)                                   # the captures
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = msm(resident, scal)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(_build.LAUNCHES)
    cols = scal.reshape(16, n // U, U).to(torch.int64).sum(dim=1).cpu()
    sums = [sum(int(v) << (16 * l) for l, v in enumerate(cols[:, u].tolist())) % spec.fr.p
            for u in range(U)]
    words = out.reshape(3, 2, spec.fq.nwords).cpu().numpy().view(np.uint32)
    X, Y, Z = (tuple(words_to_int(c) for c in coord) for coord in words)
    ok = max(*X, *Y, *Z) < spec.fq.p and Z != (0, 0)
    if ok:
        zi = bn254_g2.inv(Z)
        ok = (bn254_g2.mul(X, zi), bn254_g2.mul(Y, zi)) == bn254_g2.tiled_msm(pts, sums)
    chunks = n // msm.plan(n, 16, None)[1]
    emit({"phase": "msm_g2_2^24_resident", "reference": "match" if ok else "MISMATCH",
          "n": n, "chunks": chunks, "ms": ms, "launches": counts})
    if not ok:
        raise AssertionError("G2 msm 2^24: result differs from the reference")
    check_launches("msm_g2_2^24", counts, G2_MSM_NEEDS)
    g1 = {k: counts[k] for k in ("scan_gathered", "scan_mixed", "ec_add", "reduce_buckets",
                                 "reduce_cols", "dbl_n", "fold_horner") if counts[k]}
    if (g1 or counts["fold_g2_horner"] != 1 or counts["scan_g2_gathered"] != chunks
            or counts["reduce_g2_buckets"] != chunks or counts["reduce_g2_cols"] != 4 * chunks):
        raise AssertionError(f"G2 msm 2^24: launches {counts} for {chunks} chunks")
    return counts


# ------------------------------------------------------------ phase 5
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
    from blaze_tpu_torch.oracle.gen import rand_words

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


def ntt_main_timing(plan, sol, seed: int, device):
    """K7-K9 at the shapes of a 2^27 transform (`plan`: bls12_381_fr, or
    bls12_377_fq at W = 12): K7 at each of its three levels (level 0 reads
    the input's rows and writes the plan's buffer, levels 1 and 2 update it
    in place), K9 at depths 0 and 1, K8 at the 2^16 plan's twiddle call
    (two operands in place, its only main-path use) and with three
    operands: time, bound, and the kernel's output on a cut (K7 2^11 lanes,
    K9 2^20 rows) against the plain version on the same cut.  Keyed by the
    launch counter of the field's build ("ntt_base", "ntt_base_w12"), then
    the level or depth; each entry names its counter ("kernel")."""
    import torch

    from blaze_tpu_torch.bench.profile import cuda_ms, work_bound_ms
    from blaze_tpu_torch.ntt import FusedNTT
    from blaze_tpu_torch.oracle.gen import rand_words

    spec = plan.spec
    W = spec.nwords
    k = plan.kern
    timing = {}

    def measure(key, name, shape, kern, check, plain, cut, plain_shape, reps):
        """kern: the timed launch; check: the kernel's output on the plain
        version's inputs; cut: the rows both cover."""
        ms = cuda_ms(kern, reps)
        want, plain_ms = once_ms(plain)
        e = max_abs_err(cut(check()), cut(want))
        bound, bound_by = work_bound_ms(name, shape, W, sol)
        timing[key] = {"kernel": k.counter(name), "shape": shape, "ms": ms,
                       "plain_ms": plain_ms, "plain_shape": plain_shape, "bound_ms": bound,
                       "bound_by": bound_by, "max_abs_err": e}
        del want
        torch.cuda.empty_cache()

    n = plan.n
    lane_cut, row_cut = min(1 << 11, n >> 9), min(1 << 20, n)
    x = rand_words(spec, (n, W), seed, device)
    buf = rand_words(spec, (n, W), seed + 1, device)
    for d, lv in enumerate(plan.levels):
        key = k.counter("ntt_base") + ("" if d == 0 else f"_level{d}")
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
        key = k.counter("twiddle_mul") + ("" if d == 0 else f"_depth{d}")
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
    for key, ops in ((k.counter("mul_lm"), (rows,)),
                     (k.counter("mul_lm") + "_3_operands", (rows, z))):
        shape = {"M": small.n, "N": 1, "operands": 1 + len(ops)}
        timed = ((lambda: k.mul_lm(ybuf, rows, out=ybuf)) if len(ops) == 1 else
                 (lambda ops=ops: k.mul_lm(y, *ops)))
        measure(key, "mul_lm", shape, timed, lambda ops=ops: k.mul_lm(y, *ops),
                lambda ops=ops: k.mul_lm_plain(y, *ops), lambda o: o, shape, 50)
    return timing


def ntt_transform_split(plan, seed: int, device, want: dict) -> dict:
    """One warm transform (plan.ntt) timed whole with CUDA events and traced
    under torch.profiler (device_split), and the transform's peak memory.
    `want`: the launches of each kernel; any other count, or any other
    device operation, raises."""
    import torch

    from blaze_tpu_torch.bench.profile import SPLIT, cuda_ms, device_split
    from blaze_tpu_torch.oracle.gen import rand_words

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
    emit({"phase": f"ntt_2^{plan.logn}_split", "field": plan.spec.name, **info})
    got = {k: split[f"{k}_launches"] for k in SPLIT}
    if got != {**dict.fromkeys(SPLIT, 0), **want}:
        raise AssertionError(f"ntt 2^{plan.logn}: device operations {got}, want {want} "
                             f"and nothing else")
    return info


def phase_ntt_parity(sol, seed: int, device):
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT, NTTKernels

    errs = {}
    for field in NTT_FIELDS:
        checked = []
        k = NTTKernels.for_spec(FIELDS[field])
        for name, kern, plain, shape in ntt_kernel_cases(FIELDS[field], seed, device):
            e = max_abs_err(kern(), plain())
            errs[k.counter(name)] = max(errs.get(k.counter(name), 0), e)
            checked.append({"kernel": k.counter(name), **shape, "max_abs_err": e})
        torch.cuda.synchronize()
        emit({"phase": "ntt_parity", "field": field, "shape": "small", "cases": checked})
        if any(c["max_abs_err"] for c in checked):
            raise AssertionError(f"{field}: NTT kernel differs from its plain version")
    dev = torch.device("cuda", torch.cuda.current_device())     # the plan's device, indexed
    plan = FusedNTT(FIELDS["bls12_381_fr"], 27, device=dev)
    timing = ntt_main_timing(plan, sol, seed, dev)
    emit({"phase": "ntt_parity", "field": "bls12_381_fr", "shape": "main path (2^27)",
          "kernels": timing})
    for t in timing.values():
        errs[t["kernel"]] = max(errs[t["kernel"]], t["max_abs_err"])
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("NTT kernel differs from its plain version at the main shapes")
    del plan
    torch.cuda.empty_cache()
    ntt_splits(seed, "bls12_381_fr")
    return errs, timing


SPLIT_WANT = {27: {"ntt_base": 3, "twiddle_mul": 2}, 16: {"ntt_base": 2, "mul_lm": 1}}


def ntt_splits(seed: int, field: str) -> list:
    """ntt_transform_split of the 2^27 plan (K7 x3, K9 x2) and the 2^16 plan
    (K7 x2, K8 x1) on `field`, each in a fresh process of its own (the
    profiler keeps every event only in a young one)."""
    return [fresh("ntt_split", seed, field, logn) for logn in SPLIT_WANT]


def ntt_split(seed: int, field: str, logn: int) -> dict:
    """ntt_transform_split of the 2^logn plan on `field`, SPLIT_WANT's
    launches and nothing else; run in a fresh process (`fresh`)."""
    import torch

    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT

    dev = torch.device("cuda", torch.cuda.current_device())
    return ntt_transform_split(FusedNTT(FIELDS[field], logn, device=dev), seed, dev,
                               SPLIT_WANT[logn])


# --------------------------------------------------------- phases 6 and 7
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
    from blaze_tpu_torch.oracle.checks import evaluate_on_card, word_ints
    from blaze_tpu_torch.fields import FIELDS, int_to_words
    from blaze_tpu_torch.oracle.gen import host_vector
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
    from blaze_tpu_torch.oracle.checks import word_ints
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.oracle.gen import host_vector
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


# ------------------------------------------------------ the wide NTT phase
def plan_launches(plan) -> dict:
    """The launches of one plan.ntt: K7 per level, K9 per twiddle, or K8 where
    the plan's twiddle cell takes the fallback; under the counters of the
    plan's width."""
    want = {plan.kern.counter("ntt_base"): len(plan.levels)}
    for d in range(len(plan.levels) - 1):
        key = plan.kern.counter("mul_lm" if plan._takes_k8(d) else "twiddle_mul")
        want[key] = want.get(key, 0) + 1
    return want


def phase_ntt_wide(sol, seed: int, logn: int = 27, dist_logn: int = 24, small_logn: int = 16,
                   past7: tuple = (22, 3), device=None) -> tuple:
    """Phase 7d (ntt_377fq_2^27): NTTs over the 12-word bls12_377_fq
    (48-byte elements) on the card.  K7-K9's W = 12 builds at the 2^logn
    plan's shapes (ntt_main_timing); one warm transform (CUDA events; K7 x3
    and K9 x2, nothing else, in a fresh child's profile, with the 2^16
    plan's K7 x2 and K8 x1) held by its inverse and by the input polynomial
    evaluated at W^k at 8 indices (evaluate_on_card: K1 products and integer
    sums, no NTT kernel); NTTClient forward and inverse on two vectors
    (field_vector from the seed), each output equal to the plan's on the
    card and each inverse back to the input bytes, with set_data,
    start->wait and result seconds and the peak memory; the client at 2^16
    (the K8 fallback) against a host NTT in Python ints; DistributedNTT at
    2^dist_logn on a mesh of one (NCCL) against FusedNTT, and back; a plan
    past 7 levels at klog 3 against the klog-9 plan.  `device` (default:
    the current card) and the sizes let the CPU rehearse the phase.
    Returns (errors, timing, launches), keyed by the W = 12 counters."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import cuda_ms
    from blaze_tpu_torch.oracle.checks import evaluate_on_card, word_ints
    from blaze_tpu_torch.dist import DistributedNTT, make_mesh
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT
    from blaze_tpu_torch.oracle.gen import field_vector, rand_words
    from blaze_tpu_torch.runtime import NTTClient, NTTInit

    spec = FIELDS[WIDE_NTT_FIELD]
    W, n, p = spec.nwords, 1 << logn, spec.p
    dev = device or torch.device("cuda", torch.cuda.current_device())
    launches = {}

    def counted(phase, counts, want):
        """Add a run's counts to the launches; raise unless exactly `want`."""
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        got = {k: v for k, v in counts.items() if v}
        if got != want:
            raise AssertionError(f"{phase}: launches {got}, want {want}")

    # ---- the kernels at the 2^logn plan's shapes
    plan = FusedNTT(spec, logn, device=dev)
    timing = ntt_main_timing(plan, sol, seed, dev)
    emit({"phase": "ntt_parity", "field": spec.name, "shape": f"main path (2^{logn})",
          "kernels": timing})
    errs = {}
    for t in timing.values():
        errs[t["kernel"]] = max(errs.get(t["kernel"], 0), t["max_abs_err"])
    if any(errs.values()):
        raise AssertionError("a W = 12 NTT kernel differs from its plain version")
    torch.cuda.empty_cache()
    split = ntt_splits(seed, spec.name)

    # ---- one transform: inverse, sampled evaluations, warm time
    t0 = time.perf_counter()
    vecs = [field_vector(spec, n, seed + i) for i in range(2)]
    gen_s = time.perf_counter() - t0
    x = torch.from_numpy(vecs[0].view(np.int32)).to(dev)
    out, run = timed_run(lambda: plan.ntt(x))
    counted("ntt_377fq transform", run["launches"], plan_launches(plan))
    transform_ms = cuda_ms(lambda: plan.ntt(x), 3)
    roundtrip = bool(torch.equal(plan.intt(out), x))
    rng = np.random.default_rng(seed)
    ks = [0, 1, n - 1] + [int(v) for v in rng.integers(2, n - 1, size=5)]
    got = word_ints(out[ks].cpu().numpy().view(np.uint32))
    evaluations = got == evaluate_on_card(spec, x, spec.root_of_unity(logn), ks)
    del out, x
    torch.cuda.empty_cache()
    info = {"field": spec.name, "n": n, "element_bytes": spec.nbytes, "parts": plan.parts,
            "transform_ms": transform_ms, "elements_per_s": n / transform_ms * 1e3,
            "split": [{k: v for k, v in sp.items() if k != "other_ops"} for sp in split],
            "once": run, "roundtrip": roundtrip, "evaluations_match": evaluations,
            "input_gen_s": gen_s}

    # ---- the client at 2^logn: two vectors, forward and inverse
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fwd = NTTClient(NTTInit(field=spec.name, logn=logn))
    inv = NTTClient(NTTInit(field=spec.name, logn=logn), inverse=True)
    plan_s = time.perf_counter() - t0
    runs = []
    for i, v in enumerate(vecs):
        _build.reset_launches()
        o, secs = run_ntt_client(fwd, v)
        counted(f"ntt_377fq client {i}", dict(_build.LAUNCHES), plan_launches(fwd.plan))
        with warnings.catch_warnings():         # read-only bytes, only read here
            warnings.simplefilter("ignore", UserWarning)
            y = torch.frombuffer(o, dtype=torch.int32).view(n, W).to(dev)
        equal = bool(torch.equal(y, plan.ntt(torch.from_numpy(v.view(np.int32)).to(dev))))
        del y
        back, secs_inv = run_ntt_client(inv, o)
        del o
        runs.append({"vector": i, "forward": secs, "inverse": secs_inv,
                     "equals_plan": equal, "roundtrip": back == v.tobytes()})
        del back
    del vecs, plan
    info["client"] = {"plan_s": plan_s, "runs": runs,
                      "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    del fwd, inv
    torch.cuda.empty_cache()

    # ---- the 2^16 plan through the client (K7 x2, K8 x1) against a host NTT
    v = field_vector(spec, 1 << small_logn, seed + 16)
    small = NTTClient(NTTInit(field=spec.name, logn=small_logn))
    _build.reset_launches()
    o, secs = run_ntt_client(small, v)
    counted("ntt_377fq 2^16", dict(_build.LAUNCHES), {"ntt_base_w12": 2, "mul_lm_w12": 1})
    want = host_ntt(word_ints(v), spec.root_of_unity(small_logn), p)
    back, _ = run_ntt_client(NTTClient(NTTInit(field=spec.name, logn=small_logn),
                                       inverse=True), o)
    info["2^16"] = {**secs, "host_ntt": o == b"".join(c.to_bytes(spec.nbytes, "little")
                                                      for c in want),
                    "roundtrip": back == v.tobytes()}

    # ---- DistributedNTT on a mesh of one at 2^dist_logn, and back
    try:
        mesh = make_mesh({"sp": 1}, device_type=dev.type)
        dntt = DistributedNTT(spec, dist_logn, mesh, axis="sp", logn1=dist_logn // 2)
        x = rand_words(spec, (1 << dist_logn, W), seed + 7, dev)
        xk, run = timed_run(lambda: dntt.ntt(x))
        counted("ntt_377fq DistributedNTT", run["launches"],
                {"ntt_base_w12": len(dntt.plan1.levels) + len(dntt.plan2.levels),
                 "twiddle_mul_w12": len(dntt.plan1.levels) + len(dntt.plan2.levels) - 1})
        equal = bool(torch.equal(dntt.spectral_to_natural(xk),
                                 FusedNTT(spec, dist_logn, device=dev).ntt(x)))
        info["dist"] = {"n": 1 << dist_logn, "logn1": dist_logn // 2, **run,
                        "equals_fused_ntt": equal,
                        "roundtrip": bool(torch.equal(dntt.intt(xk), x))}
        del x, xk
    finally:
        dist.destroy_process_group()

    # ---- a plan past 7 levels at klog 3 against the klog-9 plan
    deep = FusedNTT(spec, past7[0], klog=past7[1], device=dev)
    x = rand_words(spec, (deep.n, W), seed + 22, dev)
    flat = FusedNTT(spec, deep.logn, device=dev)
    info["deep_plan"] = {"n": deep.n, "parts": deep.parts, "klog9_parts": flat.parts,
                         "equal": bool(torch.equal(deep.ntt(x), flat.ntt(x))
                                       and torch.equal(deep.intt(x), flat.intt(x)))}
    del x, deep, flat
    torch.cuda.empty_cache()
    emit({"phase": f"ntt_377fq_2^{logn}", **info})
    oks = [roundtrip, evaluations, *(r["equals_plan"] and r["roundtrip"] for r in runs),
           info["2^16"]["host_ntt"], info["2^16"]["roundtrip"], info["dist"]["equals_fused_ntt"],
           info["dist"]["roundtrip"], info["deep_plan"]["equal"]]
    if not all(oks):
        raise AssertionError(f"ntt_377fq_2^{logn}: a check failed: {oks}")
    return errs, timing, launches


# ------------------------------------------------------- pipeline phase
PIPELINE_UNIQUE = 256          # subgroup points, tiled to the MSM's size


def pipeline_trace_split(trace: Path, wall_s: float, launched: dict) -> dict:
    """Device time per stream from a torch.profiler Chrome trace: the NTT's
    stream (the one that ran ntt_base_kernel) and every other (the MSM's),
    their union, the card's idle share of `wall_s`, and each stream's
    operations and milliseconds.  Raises TraceLost when the trace holds
    fewer events of a kernel than `launched` (launch-counter key -> count
    in the traced window)."""
    from blaze_tpu_torch.trace import check_trace, traced_launches

    events = [e for e in json.loads(trace.read_text()).get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check_trace(traced_launches((e["name"], 1) for e in events), launched, "pipeline trace")
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
    return {"ntt_stream_ms": ntt,
            "msm_stream_ms": sum(v["ms"] for v in streams.values()) - ntt,
            "device_busy_ms": busy / 1e3, "device_ops": len(events),
            "idle_share": 1 - busy / 1e6 / wall_s, "streams": streams}


def pipeline_setup(seed: int, ntt_logn: int, msm_logn: int):
    """The pipeline phase's ProofPipeline (BLS12-381) on the card, its
    resident points (PIPELINE_UNIQUE order-r subgroup points from the seed,
    tiled to 2^msm_logn), its three batches' terms (pipeline_terms) and a
    function making a batch's coefficients on the card."""
    import numpy as np
    import torch

    from blaze_tpu_torch.oracle.checks import coeff_batch, pipeline_terms
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.msm import points_to_resident
    from blaze_tpu_torch.oracle import ECOracle
    from blaze_tpu_torch.oracle.gen import points_to_affine_words
    from blaze_tpu_torch.pipeline import ProofPipeline

    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    n, m = 1 << ntt_logn, 1 << msm_logn
    U = min(PIPELINE_UNIQUE, m)
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(U)]
    terms = pipeline_terms(spec.fr.p, n, seed)
    pipe = ProofPipeline(cv, ntt_logn, msm_logn)
    dev = pipe.ctx.device
    pts = torch.from_numpy(points_to_affine_words(spec, upoints).view(np.int32)).to(dev)
    resident = points_to_resident(cv, pts).repeat(1, m // U)

    return pipe, resident, terms, upoints, lambda t: coeff_batch(t, n, spec.fr.nwords, dev)


def pipeline_profile(seed: int, ntt_logn: int, msm_logn: int) -> dict:
    """The pipeline phase's three batches through run_batches with the
    middle batch under torch.profiler (DeviceContext.profile): its wall
    seconds, pipeline_trace_split of its trace (checked against the launch
    counters), and the SHA-256 of each batch's result bytes; run in a fresh
    process (`fresh`)."""
    import shutil

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.runtime.device import TRACE_FILE

    pipe, resident, terms, _, batch = pipeline_setup(seed, ntt_logn, msm_logn)
    trace_dir = ROOT / "build" / f"pipeline_trace_{os.getpid()}"
    runs = pipe.run_batches((batch(t) for t in terms), resident)
    results = [next(runs).cpu().numpy().tobytes()]
    try:
        before = dict(_build.LAUNCHES)
        with pipe.ctx.profile(trace_dir):
            t0 = time.perf_counter()
            results.append(next(runs).cpu().numpy().tobytes())
            profiled_s = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        split = pipeline_trace_split(trace_dir / TRACE_FILE, profiled_s, launched)
        split["trace_mib"] = (trace_dir / TRACE_FILE).stat().st_size / 2**20
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    results += [res.cpu().numpy().tobytes() for res in runs]
    return {"profiled_batch_s": profiled_s, **split,
            "results_sha256": [hashlib.sha256(b).hexdigest() for b in results]}


def phase_pipeline(seed: int, ntt_logn: int = 27, msm_logn: int = 24) -> dict:
    """The proof pipeline (ProofPipeline, BLS12-381) at the reference's NTT
    size and the headline MSM size: three batches made on the card, run
    serially (one batch at a time, synchronised, launch counts per batch)
    and then through run_batches; the results must be equal byte for byte
    and each equal its geometric oracle.  One more pipelined run is
    profiled around its middle batch in a fresh process
    (pipeline_profile), its results equal to these.  Returns the launch
    counts of the serial runs."""
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import cuda_ms
    from blaze_tpu_torch.oracle.checks import pipeline_expected
    from blaze_tpu_torch.curves import CURVES

    spec = CURVES["bls12_381"]
    m = 1 << msm_logn
    t0 = time.perf_counter()
    pipe, resident, terms, upoints, batch = pipeline_setup(seed, ntt_logn, msm_logn)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cv, U = pipe.curve, len(upoints)
    t0 = time.perf_counter()
    expected = pipeline_expected(spec, upoints, terms, ntt_logn, m)
    oracle_s = time.perf_counter() - t0

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
    torch.cuda.empty_cache()
    prof = fresh("pipeline_profile", seed, ntt_logn, msm_logn)
    profiled_equal = prof.pop("results_sha256") == [hashlib.sha256(b).hexdigest()
                                                    for b in serial]

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
    # per later level, K2 per chunk of the MSM, K6 once, no K1 (the chunk's
    # group ops are on K3 and KF); at (2^27, 2^24): K7 x3, K9 x2, K2 x32,
    # K6 x1 and no K8
    k8 = sum(pipe.plan._takes_k8(d) for d in range(len(pipe.plan.levels) - 1))
    want = {"ntt_base": len(pipe.plan.levels), "mul_lm": k8,
            "twiddle_mul": len(pipe.plan.levels) - 1 - k8,
            "scan_gathered": -(-m // (1 << pipe.msm.config.chunk_log2)), "fold_horner": 1,
            "scan_mixed": 0, "poseidon_perm": 0, "mont_mul": 0}
    per_batch = pipelined_s / len(terms)
    info = {"curve": "bls12_381", "ntt_logn": ntt_logn, "msm_logn": msm_logn,
            "unique_points": U, "batches": [[[row, str(v)] for row, v in t] for t in terms],
            "oracle_s": oracle_s, "setup_s": setup_s,
            "serial_s": serial_s, "serial_per_batch_s": sum(serial_s) / len(terms),
            "pipelined_s": pipelined_s, "pipelined_per_batch_s": per_batch,
            "proofs_per_s": 1 / per_batch, "ntt_and_scalars_ms": ntt_ms,
            **prof, "max_memory_allocated_gib": peak / 2**30,
            "launches_per_batch": counts, "launches_want": want,
            "pipelined_equals_serial": piped == serial,
            "profiled_equals_serial": profiled_equal,
            "distinct_results": len(set(serial)) == len(serial), "oracle": oracle_ok}
    emit({"phase": "pipeline", **info})
    for i, c in enumerate(counts):
        check_msm_launches(f"pipeline batch {i}", c)
        bad = {k: c[k] for k, v in want.items() if c[k] != v}
        if bad:
            raise AssertionError(f"pipeline batch {i}: launches {bad}, want {want}")
    if not (all(oracle_ok) and piped == serial and profiled_equal
            and len(set(serial)) == len(serial)):
        raise AssertionError(f"pipeline: oracle {oracle_ok}, pipelined == serial "
                             f"{piped == serial}, profiled == serial {profiled_equal}, "
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
    from blaze_tpu_torch.oracle.gen import rand_words

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


def four_step_timing(dntt, sol, seed: int, device) -> tuple:
    """K7 at each batched level of the 2^27 four-step's sub-plans and K9 at
    their twiddles and at the inter-pass twiddle (this rank's tables), at
    the main path's maps: time (CUDA events), bound, and the kernel's
    output against the plain version on a cut (K7 2^11 lanes, K9 2^20
    rows).  Returns (timing, max error per kernel)."""
    import torch

    from blaze_tpu_torch.bench.profile import cuda_ms, work_bound_ms
    from blaze_tpu_torch.ntt.fused import batch_level
    from blaze_tpu_torch.oracle.gen import rand_words

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
            bound, by = work_bound_ms("ntt_base", shape, W, sol)
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
                bound, by = work_bound_ms("twiddle_mul", shape, W, sol)
                timing[key] = {**shape, "ms": ms, "bound_ms": bound, "bound_by": by,
                               "plain_ms": plain_ms, "plain_rows": y.shape[0], "max_abs_err": e}
                errs["twiddle_mul"] = max(errs["twiddle_mul"], e)
                del y, got, want
    del x, buf
    torch.cuda.empty_cache()
    return timing, errs


def phase_dist(sol, seed: int, ntt_logn: int = 27, msm_logn: int = 24,
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

    from blaze_tpu_torch.bench.profile import SPLIT, cuda_ms
    from blaze_tpu_torch.oracle.checks import pipeline_expected, pipeline_terms
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.dist import DistributedMSM, DistributedNTT, make_mesh
    from blaze_tpu_torch.fields import FIELDS, int_to_words
    from blaze_tpu_torch.msm import MSM, points_to_resident
    from blaze_tpu_torch.oracle.gen import (points_to_affine_words, rand_words,
                                            subgroup_msm_instance)
    from blaze_tpu_torch.pipeline import ProofPipeline

    dev = device or torch.device("cuda", torch.cuda.current_device())
    spec = CURVES["bls12_381"]
    cv = Curve(spec)
    fr = FIELDS["bls12_381_fr"]
    errs = {"ntt_base": 0, "twiddle_mul": 0}
    launches, info = {}, {}
    from blaze_tpu_torch.ntt import NTTKernels

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
        counter = NTTKernels.for_spec(FIELDS[field]).counter
        for name, kern, plain, shape in batched_kernel_cases(FIELDS[field], seed, dev):
            e = max_abs_err(kern(), plain())
            errs[counter(name)] = max(errs.get(counter(name), 0), e)
            checked.append({"field": field, "kernel": counter(name), **shape,
                            "max_abs_err": e})
    emit({"phase": "dist_batched_parity", "cases": checked})
    if any(c["max_abs_err"] for c in checked):
        raise AssertionError("a batched K7/K9 call differs from its plain version")

    try:
        mesh = make_mesh({"dp": 1}, device_type=dev.type)
        info["backend"] = str(dist.get_backend())
        # ---- DistributedMSM at 2^msm_logn against MSM.__call__ and the oracle
        m = 1 << msm_logn
        t0 = time.perf_counter()
        upoints, scal_np, want = subgroup_msm_instance(spec, m, seed + 5)
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
        if run["launches"]["mont_mul"]:
            raise AssertionError(f"DistributedMSM: {run['launches']['mont_mul']} K1 launches "
                                 "on resident operands, want 0")
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
        timing, kerr = four_step_timing(dntt, sol, seed, dev)
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
        split = fresh("dist_ntt_split", seed + 6, ntt_logn, logn1)
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
        emit({"phase": "dist_ntt", **info["ntt"]})
        split_bad = {k_: split[f"{k_}_launches"] for k_ in SPLIT} != {
            **dict.fromkeys(SPLIT, 0), **want_counts}
        if bad or split_bad or not (equal and roundtrip):
            raise AssertionError(f"DistributedNTT 2^{ntt_logn}: launches {bad}, equal {equal}, "
                                 f"roundtrip {roundtrip}, profiled device ops {split}")
        torch.cuda.empty_cache()

        # ---- run_dist at (ntt_logn, msm_logn) on {dp: 1, sp: 1}
        mesh2 = make_mesh({"dp": 1, "sp": 1}, device_type=dev.type)
        r = spec.fr.p
        terms = pipeline_terms(r, 1 << ntt_logn, seed + 7)[2]       # a e_j + b e_k'
        up = upoints                                 # the MSM instance's subgroup points
        U = len(up)
        t0 = time.perf_counter()
        want = pipeline_expected(spec, up, [terms], ntt_logn, m)[0]
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


def dist_ntt_split(seed: int, ntt_logn: int, logn1: int) -> dict:
    """device_split of one warm DistributedNTT transform at 2^ntt_logn on
    bls12_381_fr (logn1) on a mesh of one rank (NCCL), its input
    rand_words(seed); run in a fresh process (`fresh`)."""
    import torch
    import torch.distributed as dist

    from blaze_tpu_torch.bench.profile import device_split
    from blaze_tpu_torch.dist import DistributedNTT, make_mesh
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.oracle.gen import rand_words

    fr = FIELDS["bls12_381_fr"]
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = make_mesh({"sp": 1}, device_type=dev.type)
        dntt = DistributedNTT(fr, ntt_logn, mesh, axis="sp", logn1=logn1)
        x = rand_words(fr, (1 << ntt_logn, fr.nwords), seed, dev)
        dntt.ntt(x)
        return device_split(lambda: dntt.ntt(x))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- Poseidon phases
POSEIDON_FIELD = "bls12_381_fr"


def near_p_states(spec, t: int, B: int, seed: int, device):
    """(t, W, B) canonical words: random values below 2^(bits-1), and every
    7th state's elements p-1-k (k < 5): canonical inputs near p, which
    convert_in must not find reduced by accident."""
    import numpy as np
    import torch

    from blaze_tpu_torch.fields import int_to_words
    from blaze_tpu_torch.oracle.gen import rand_words

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


def poseidon_main_timing(sol, seed: int, device):
    """K10 at the height-9 tree's shapes on bls12_381_fr — the leaf sponge
    (t = 12, B = 2^24, convert_in) and the first node level (t = 9,
    B = 2^21): one warm call whose first 2^10 states are held against the
    plain version on the same cut, then timed calls (CUDA events).  The
    bound counts the sparse schedule's work; dense_bound_ms the dense
    rounds' (the TPU kernel's)."""
    import torch

    from blaze_tpu_torch.bench.profile import cuda_ms, work_bound_ms
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import PoseidonKernels, generate_params
    from blaze_tpu_torch.oracle.gen import rand_words

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
        bound, bound_by = work_bound_ms("poseidon_perm", shape, W, sol)
        dense, _ = work_bound_ms("poseidon_perm", {**shape, "sparse": 0}, W, sol)
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


def phase_poseidon_parity(sol, seed: int, device):
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
    for field in SCALAR_FIELDS:
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
    timing = poseidon_main_timing(sol, seed, device)
    emit({"phase": "poseidon_parity", "field": POSEIDON_FIELD,
          "shape": "main path (height 9)", "kernels": timing})
    if any(t["max_abs_err"] for t in timing.values()):
        raise AssertionError("K10 differs from its plain version at the main shapes")
    return {"poseidon_perm": max([err] + [t["max_abs_err"] for t in timing.values()])}, timing


def phase_poseidon_h4(seed: int) -> dict:
    """The reference's own contract (integration_poseidon.rs:23,151-155):
    height 4, 512 leaves of 11 wire elements, 585 nodes, every node against
    the oracle; then TREE_D at height 4.  Returns the launch counts."""
    import numpy as np

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.oracle.checks import parse_records
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
    from blaze_tpu_torch.oracle.checks import check_tree
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import LEAF_ARITY
    from blaze_tpu_torch.oracle.gen import host_vector
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

    same = raws[0] == raws[1]
    check = check_tree(raws[0], elems, h, spec, seed)
    raws = None
    info = {"height": h, "leaves": n, "elements": LEAF_ARITY * n,
            "wire_gib": LEAF_ARITY * n * spec.nbytes / 2**30, "input_gen_s": gen_s,
            "set_data_s": set_s, "builds": builds, "second_build_equal": same, **check,
            "max_memory_allocated_gib": peak / 2**30, "launches": counts}
    emit({"phase": "poseidon_h9", **info})
    if not (check["ok"] and same):
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
    from blaze_tpu_torch.oracle.checks import parse_records
    from blaze_tpu_torch.hash import LEAF_ARITY, num_tree_nodes
    from blaze_tpu_torch.oracle.gen import host_vector
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


# ------------------------------------------------------- the experiments phase
EXPERIMENT_KERNELS = ("probe_chain", "mont_tc")


def product_counts(recs: list) -> list:
    """Per product, for each form of the Montgomery product among E2's
    records (K0's mont beside mont_hi and the other forms, W = 8 and 12):
    the step loop's FMA-pipe slots, ALU-pipe operations and instructions
    (SASS, chain.op_summary), the kernel's registers, ns per product and
    one product's latency on one warp (E2's latency records)."""
    from blaze_tpu_torch.experiments.chain import PRODUCT_BODIES

    forms = [r for r in recs if r["probe"] == "E2" and r["port_body"] in PRODUCT_BODIES]
    latency = {(r["port_body"], r["W"]): r["step_ms"] for r in forms
               if r["body"].endswith(" latency")}
    out = []
    for r in forms:
        if r["body"] != r["port_body"]:
            continue
        ops = r.get("sass") or {}
        lat = latency.get((r["port_body"], r["W"]))
        out.append({"body": r["body"], "field": r["field"], "W": r["W"],
                    "fma_slots": ops.get("fma_slots"), "alu": ops.get("alu"),
                    "instructions": ops.get("total"), "imad_wide": ops.get("imad_wide"),
                    "imad_mov": ops.get("imad_mov"), "imad_x": ops.get("imad_x"),
                    "registers": r.get("registers"), "ns_per_elem_op": r.get("ns_per_elem_op"),
                    "latency_us": None if lat is None else lat * 1e3})
    return out


def phase_experiments(sol, device):
    """The five probes of experiments/ (blaze_tpu_torch.experiments, E1-E5)
    at the cut size (experiments.CUT: 2^16 lanes, chains of at most 9
    steps), every lane of every body held against its plain version, limit
    0, with the launch counts zeroed before and read after (probe_chain and
    mont_tc must both launch); one line of times.  Then the kernels line's
    numbers: probe_chain as E2's mont body (W = 12, 2^16 lanes, M = 9) and
    mont_tc as E1's one product (W = 12, 2^16), each timed (CUDA events)
    beside its plain version and its bound (chain.work_bound: bytes, IMADs
    and int8 tensor-core operations).  Returns (errors, timing, launches)."""
    import torch

    from blaze_tpu_torch import _build
    from blaze_tpu_torch.bench.profile import cuda_ms, product_imads
    from blaze_tpu_torch.experiments import failures, run_all
    from blaze_tpu_torch.experiments.chain import (mont_tc, mont_tc_plain, probe_chain,
                                                   probe_chain_plain, tc_work, work_bound)
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.oracle.gen import rand_words

    _build.reset_launches()
    recs = run_all(device, cut=True)
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] for k in EXPERIMENT_KERNELS}
    keep = ("probe", "body", "field", "S", "M", "ms", "step_ms", "ns_per_elem_op",
            "imad_fraction", "fma_pipe_fraction", "tc_fraction", "max_abs_err")
    emit({"phase": "experiments", "launches": counts,
          "records": [{k: r[k] for k in keep if k in r} for r in recs]})
    emit({"phase": "experiments_products", "products": product_counts(recs)})
    check_launches("experiments", counts, EXPERIMENT_KERNELS)
    if failures(recs):
        raise AssertionError(f"experiments: kernels differ from their plain versions: "
                             f"{[(r['probe'], r['body'], r['field']) for r in failures(recs)]}")
    spec = FIELDS["bls12_381_fq"]
    W, n, M = spec.nwords, 1 << 16, 9
    a, b = rand_words(spec, (n, W), 21, device), rand_words(spec, (n, W), 22, device)
    cases = {
        "probe_chain": (lambda: probe_chain(spec, "mont", a, b, M),
                        lambda: probe_chain_plain(spec, "mont", a, b, M),
                        (3 * n * W * 4, M * n * product_imads(W), 0),
                        {"body": "mont", "W": W, "lanes": n, "M": M}),
        "mont_tc": (lambda: mont_tc(spec, "mont", a, b), lambda: mont_tc_plain(spec, "mont", a, b),
                    tc_work(spec, n), {"mode": "mont", "W": W, "lanes": n, "M": 1}),
    }
    errs, timing = {}, {}
    for name, (kern, plain, work, shape) in cases.items():
        ms = cuda_ms(kern, 20)
        want, plain_ms = once_ms(plain)
        errs[name] = max_abs_err(kern(), want)
        bound, bound_by = work_bound(work, sol)
        timing[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "max_abs_err": errs[name]}
    emit({"phase": "experiments_kernels", "kernels": timing})
    if any(errs.values()):
        raise AssertionError(f"experiments: kernels differ from their plain versions: {errs}")
    return errs, timing, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    card, sol = timed_phase("device_and_build", phase_device)
    errs, timing = timed_phase("msm_parity", phase_parity, sol, dev)
    errs["field_ew"], ew_timing = timed_phase("field_ew_parity", phase_field_ew, sol, dev)
    timing.update(ew_timing)
    launches = timed_phase("msm_clients", phase_main_path, args.seed)
    timed_phase("msm_2^19_chunk_graph", phase_chunk_graph, args.seed)
    for k, v in timed_phase("msm_2^24", phase_msm_2e24, args.seed).items():
        launches[k] += v
    for k, v in timed_phase("msm_g2_2^24", phase_g2_msm_2e24, args.seed).items():
        launches[k] += v
    timed_phase("msm_2^19_profile", fresh, "profile_single_chunk", args.seed)
    ntt_errs, ntt_timing = timed_phase("ntt_parity", phase_ntt_parity, sol, args.seed, dev)
    errs.update(ntt_errs)
    timing.update(ntt_timing)
    for counts in (timed_phase("ntt_2^27", phase_ntt_2e27, args.seed),
                   timed_phase("ntt_2^16_2^20_goldens", phase_ntt_small, args.seed)):
        for k, v in counts.items():
            launches[k] += v
    wide_errs, wide_timing, wide_counts = timed_phase("ntt_377fq_2^27", phase_ntt_wide, sol,
                                                      args.seed)
    for k, v in wide_errs.items():
        errs[k] = max(errs[k], v)
    timing.update(wide_timing)
    for k, v in wide_counts.items():
        launches[k] += v
    dist_errs, dist_counts, _ = timed_phase("dist", phase_dist, sol, args.seed)
    for k, v in dist_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in dist_counts.items():
        launches[k] += v
    for k, v in timed_phase("pipeline", phase_pipeline, args.seed).items():
        launches[k] += v
    pos_errs, pos_timing = timed_phase("poseidon_parity", phase_poseidon_parity, sol,
                                       args.seed, dev)
    errs.update(pos_errs)
    timing.update(pos_timing)
    for counts in (timed_phase("poseidon_h4", phase_poseidon_h4, args.seed),
                   timed_phase("poseidon_h9", phase_poseidon_h9, args.seed),
                   timed_phase("poseidon_stream", phase_poseidon_stream, args.seed)):
        for k, v in counts.items():
            launches[k] += v
    exp_errs, exp_timing, exp_counts = timed_phase("experiments", phase_experiments, sol, dev)
    errs.update(exp_errs)
    timing.update(exp_timing)
    for k, v in exp_counts.items():
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
