#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (blaze_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card (nvidia-smi name and power limit, CUDA, capability),
   then the kernels built from csrc/ with nvcc (seconds, registers, spills);
2. kernel parity: K1-K6 against their plain PyTorch versions on the card,
   exact, on BN254, BLS12-377 and BLS12-381 at small shapes (K2 signed and
   unsigned), then at the main path's shapes for BLS12-381 with each
   kernel's time (CUDA events), its plain version's time and its bound;
3. main path, streamed client: MSMClient(MSMInit("bls12_381")) over 2^20
   points in the reference's order initialize -> start_process -> four
   set_data chunks of wire bytes -> result();
4. main path, single-chunk client: 2^19 points, set_data -> start_process
   -> wait_result -> result() (the chunk's fold runs on K6).
   Phases 3 and 4 use 256 points of the order-r subgroup tiled and
   distinct scalars drawn uniformly from [0, r); the expected value is the
   oracle MSM of the 256 points with each point's coefficient sum mod r,
   and the result bytes must match it after z-normalisation.  Launch counts are zeroed just before
   each and read just after; every kernel of the path must have launched.
5. the kernels line: launches in phases 3-4, parity error, times, bounds.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi prints them.  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
IMAD_PER_CLK_PER_SM = 64           # 32-bit integer multiply-add, CC 9.0

# launch-counter name -> (source, the TPU kernel's pallas_call it replaces);
# in PERF.md's table these are K1-K6 in this order
KERNELS = {
    "mont_mul": ("blaze_tpu_torch/csrc/montmul.cu", "blaze_tpu/fields/mxu.py:250"),
    "scan_mixed": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:248"),
    "ec_add": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:563"),
    "reduce_cols": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:343"),
    "dbl_n": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:508"),
    "fold_horner": ("blaze_tpu_torch/csrc/ec_kernels.cu", "blaze_tpu/curves/kernels.py:444"),
}


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
    if np.unique(out, axis=0).shape[0] != n:
        raise AssertionError("scalars not distinct")
    return np.ascontiguousarray(out).view("<u2").astype(np.uint32).reshape(n, -1)


def tiled_instance(spec, n: int, seed: int):
    """Wire bytes of n points (256 oracle points tiled) and n distinct
    random scalars, and the expected affine MSM."""
    import numpy as np

    from blaze_tpu_torch.curves import encode_affine_points, encode_scalars
    from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
    from blaze_tpu_torch.oracle.gen import points_to_affine_words

    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(256)]
    pts = points_to_affine_words(spec, upoints)[np.arange(n) % 256]
    scal = random_scalars(spec, n, seed)
    ints = [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in scal]
    expected = class_sum_expected(spec, upoints, ints)
    return encode_affine_points(pts, spec), encode_scalars(scal, spec), expected


def affine_of(raw: bytes, spec):
    from blaze_tpu_torch.curves import decode_projective_result
    from blaze_tpu_torch.fields import words_to_int

    X, Y, Z = (words_to_int(v) for v in decode_projective_result(raw, spec))
    p = spec.fq.p
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


# ----------------------------------------------------------------- timing
def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)).abs()
    return int(d.max()) if d.numel() else 0


# ------------------------------------------------------------ phase 1
def ptxas_summary(logs: dict) -> dict:
    """'kernel<W>[signed]' -> [registers, stack bytes, spill-store bytes]
    from nvcc's -Xptxas -v output (device functions: registers None)."""
    import re

    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            if "Function properties for" in line:
                m = re.search(r"([a-z_]+_kernel|ec_add_[a-z]+)ILi(\d+)E(?:Lb(\d))?", line)
                name = m and f"{m.group(1)}<{m.group(2)}>" + ("s" if m.group(3) == "1" else "")
                if name:
                    out[name] = [None, 0, 0]
            elif name and "stack frame" in line:
                f = line.split()
                out[name][1:] = [int(f[0]), int(f[4])]
            elif name and "Used" in line and "registers" in line:
                out[name][0] = int(line.split("Used")[1].split()[0])
    return out


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
          "build_s": build_s, "ptxas": ptxas_summary(_build.BUILD_LOG)})
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
    """(name, kernel call, plain call, shape) for K1-K6 on one curve's inputs."""
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
    if not main:
        cases.append(("scan_mixed", lambda: k.scan_mixed(rows_s),
                      lambda: k.scan_mixed_plain(rows_s), {"C": C, "B": B, "signed": 1}))
    return cases


def work_bound_ms(name: str, shape: dict, W: int, imad_rate: float):
    """Least time for the same work: the larger of the bytes it must move
    (inputs read once, outputs written once) over HBM bandwidth and its
    32-bit multiply-adds over the card's IMAD rate.  A W-word Montgomery
    product needs 2W^2 full 32x32->64 products (2 IMADs each) and W low
    products (4W^2 + W IMADs); alg 8 has 13 products, alg 7 has 14."""
    per_mul = 4 * W * W + W
    pt = 3 * W * 4                                # bytes of one projective point
    if name == "mont_mul":
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


def phase_parity(imad_rate: float, device):
    import torch

    from blaze_tpu_torch.curves import CURVES

    errs = {name: 0 for name in KERNELS}
    for curve in ("bn254", "bls12_377", "bls12_381"):
        spec = CURVES[curve]
        checked = {}
        for name, kern, plain, shape in kernel_cases(spec, 8, 1024, 1, device, main=False):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = max(max_abs_err(g, w) for g, w in zip(got, want))
            errs[name] = max(errs[name], e)
            checked[name + ("_signed" if shape.get("signed") else "")] = e
        torch.cuda.synchronize()
        emit({"phase": "parity", "curve": curve, "shape": "small (C=8, B=1024)",
              "max_abs_err": checked})
        if any(checked.values()):
            raise AssertionError(f"{curve}: kernel differs from its plain version: {checked}")

    # the main path's shapes: BLS12-381 at a 2^19 chunk (16 windows of
    # c = 16, R = 1024 lanes, C = 512 rows; the bucket sum's first
    # reduce_cols pass is C = 256 rows of G * R2 = 8192 lanes)
    spec = CURVES["bls12_381"]
    W = spec.fq.nwords
    timing = {}
    for name, kern, plain, shape in kernel_cases(spec, 512, 16384, 2, device, main=True):
        reps = 3 if name in ("scan_mixed", "reduce_cols") else 20
        ms = cuda_ms(kern, reps)
        want, plain_ms = once_ms(plain)
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        errs[name] = max(errs[name], e)
        bound, bound_by = work_bound_ms(name, shape, W, imad_rate)
        timing[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": e}
        del want, got
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
    for phase, run, needs in [
        ("streamed", lambda: run_streamed(1 << 20, 4, seed),
         ("mont_mul", "scan_mixed", "ec_add", "reduce_cols", "dbl_n")),
        ("single_chunk", lambda: run_single(1 << 19, seed + 1), tuple(KERNELS)),
    ]:
        _build.reset_launches()
        ok, info = run()
        counts = dict(_build.LAUNCHES)
        emit({"phase": phase, "oracle": "match" if ok else "MISMATCH", **info,
              "launches": counts})
        if not ok:
            raise AssertionError(f"{phase}: result differs from the oracle")
        missing = [k for k in needs if counts[k] == 0]
        if missing:
            raise AssertionError(f"{phase}: kernels never launched: {missing}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


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

    card, imad_rate = phase_device()
    errs, timing = phase_parity(imad_rate, torch.device("cuda"))
    launches = phase_main_path(args.seed)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
