#!/usr/bin/env python3
"""Time variants of K8 (csrc/ntt_kernels.cu, mul_lm) on the card.

    python3 scripts/k8_probe.py [--reps N]

Variants: the kernel as committed (element rows, one element per thread,
16-byte loads and stores, carry.cuh's canonical product); elems_2 and
elems_4, two and four elements per thread; strided_words, the element rows
sent through the word-major kernel (each word a 4-byte load at stride N = 1,
as before the redesign, on the same product); word_serial_product, the
element rows on field.cuh's word-serial product.  Each variant is the
kernel's source with a text substitution, built with nvcc into
build/k8_probe/<variant>/ (all builds started together) and loaded with
ctypes.  threads_128 and threads_512 change the block size; empty returns
at once, the floor of one launch among back-to-back launches.  Every
variant runs the 2^16 bls12_381_fr plan's shape, (2^16, W, 1), with two
operands (the plan's call: the buffer times its element-order twiddles,
in place) and three (x * y * z), on the same inputs; its output must
equal the plain version's word for word (empty's aside).  Prints one JSON
line per variant (ptxas registers, three CUDA-event times of --reps
launches each) and the bound, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "blaze_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k8_probe"

ELEMS = "constexpr int kMulElems = 1;"
ROWS_PRODUCT = "    blz::mont_mul_cc<W, false>(a, a, b, fc);\n    if (z != nullptr) {\n      nt::ldg_el"
VARIANTS = {
    "as_committed": [],
    "elems_2": [(ELEMS, "constexpr int kMulElems = 2;")],
    "elems_4": [(ELEMS, "constexpr int kMulElems = 4;")],
    "strided_words": [("  if (N == 1) {\n    constexpr", "  if (false) {\n    constexpr")],
    "threads_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "threads_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "empty": [("  const int64_t first = (int64_t)blockIdx.x * (kThreads * kMulElems)",
               "  if (M > 0) return;\n  const int64_t first = (int64_t)blockIdx.x * (kThreads * kMulElems)")],
    "word_serial_product": [
        (ROWS_PRODUCT, ROWS_PRODUCT.replace("mont_mul_cc", "mont_mul")),
        ("      blz::mont_mul_cc<W, false>(a, a, b, fc);\n    }\n    nt::store_el",
         "      blz::mont_mul<W, false>(a, a, b, fc);\n    }\n    nt::store_el"),
    ],
}


def build(name: str, subs) -> tuple[subprocess.Popen, Path]:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d / "csrc")
    f = d / "csrc" / "ntt_kernels.cu"
    text = f.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in ntt_kernels.cu")
        text = text.replace(old, new)
    f.write_text(text)
    from blaze_tpu_torch import _build

    so = d / "libntt_kernels.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d / "csrc"), "-o", str(so), str(f)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k8_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.ntt import FusedNTT
    from blaze_tpu_torch.ntt.kernels import _ARGTYPES

    procs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    libs, ptx = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
            raise SystemExit(f"{name}: nvcc failed")
        ptx[name] = {k: v for k, v in cs.ptxas_summary({name: log}).items()
                     if k.startswith("mul_lm")}
        lib = ctypes.CDLL(str(so))
        lib.blz_mul_lm.argtypes = _ARGTYPES["blz_mul_lm"]
        lib.blz_mul_lm.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    spec = FIELDS["bls12_381_fr"]
    plan = FusedNTT(spec, 16, device=dev)
    k, W, n = plan.kern, spec.nwords, plan.n
    rows = plan._twiddle_rows(0, False).view(n, W, 1)
    x = cs.rand_words(spec, (n, W, 1), 1, dev)
    z = cs.rand_words(spec, (n, W, 1), 2, dev)
    cases = {2: (x, rows, None, k.mul_lm_plain(x, rows)),
             3: (x, rows, z, k.mul_lm_plain(x, rows, z))}
    for name, lib in libs.items():
        line = {"variant": name, "ptxas": ptx[name]}
        for ops, (a, b, c, want) in cases.items():
            # two operands in place, as the plan calls it; three into a new buffer
            out = a.clone() if c is None else torch.empty_like(a)
            a = out if c is None else a
            stream = torch.cuda.current_stream().cuda_stream

            def launch(a=a, b=b, c=c, out=out, lib=lib, stream=stream):
                rc = lib.blz_mul_lm(W, k._consts.ctypes.data, a.data_ptr(), b.data_ptr(),
                                    None if c is None else c.data_ptr(), out.data_ptr(),
                                    n, 1, stream)
                if rc:
                    raise SystemExit(f"{name}: CUDA error {rc}")

            launch()
            torch.cuda.synchronize()
            if name != "empty" and not torch.equal(out, want):
                raise SystemExit(f"{name}: {ops} operands differ from the plain version")
            line[f"ms_{ops}_operands"] = [cs.cuda_ms(launch, args.reps) for _ in range(3)]
        print(json.dumps(line), flush=True)
    clock_mhz = float(cs.smi("clocks.max.sm").split()[0])
    imad_rate = torch.cuda.get_device_properties(0).multi_processor_count \
        * cs.IMAD_PER_CLK_PER_SM * clock_mhz * 1e6
    print(json.dumps({"bound_ms": {
        f"{ops}_operands": cs.work_bound_ms("mul_lm", {"M": n, "N": 1, "operands": ops}, W,
                                            imad_rate) for ops in (2, 3)}}))
    print(cs.smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
