"""Build and load the native libraries: nvcc (the CUDA kernels) or g++ (the
host codec) by hand into shared libraries with a plain C interface, loaded
with ctypes.

Each `csrc/*.cu` becomes one library, compiled for `sm_90a` at first use into
`build/blaze_tpu_torch/<hash>/` beside the package (the hash covers every
source and header, so an edited kernel is rebuilt and a stale library is
never loaded).  `build_all()` starts one nvcc per source, all at once.  Each
`csrc/*.cpp` (HOST_SOURCES: the host codec) is compiled the same way by g++,
with no -march (the build directory may travel with a copy of the tree).
A missing compiler or a failed build raises LoadFailed: there is no
fallback to the plain PyTorch or numpy versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .utils.errors import DeviceError, LoadFailed

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "blaze_tpu_torch"
SOURCES = ("montmul", "field_ew", "ec_kernels", "ec_kernels_g2", "ntt_kernels",
           "poseidon_kernels", "probe_chain", "mont_tc", "trace_marks")
HOST_SOURCES = ("codec",)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-Wall"]

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel (never on the plain CPU path), so a run can show which kernels it
# went through.  The NTT kernels' W = 12 builds count apart (name_w12); the
# probe kernels of experiments/ count under their sources' names, the stage
# marks (trace.py) as mark_<stage>.  A device kernel's name maps to the first
# key whose `key_` it holds (trace.launch_key), so scan_gathered, whose
# kernel is scan_mixed_kernel<W, s, scan_gathered_fetch>, comes before
# scan_mixed, and reduce_buckets (reduce_cols_kernel<W,
# reduce_buckets_fetch>) before reduce_cols.  The EC kernels' F_p2
# instances (BN254 G2) count under the G1 key with g2 after its first word
# (scan_g2_gathered, ec_g2_add, ...), each its kernel's name
# (scan_g2_gathered_kernel<8, s>, ...), before the G1 key its operand
# source's name also holds (scan_gathered_fetch).
LAUNCHES = dict.fromkeys(
    ("mont_mul", "field_ew", "scan_g2_gathered", "scan_gathered", "scan_g2_mixed",
     "scan_mixed", "ec_g2_add", "ec_add", "reduce_g2_buckets", "reduce_buckets",
     "reduce_g2_cols", "reduce_cols", "dbl_g2_n", "dbl_n", "fold_g2_horner",
     "fold_horner", "ntt_base", "mul_lm", "twiddle_mul", "poseidon_perm",
     "ntt_base_w12", "mul_lm_w12", "twiddle_mul_w12", "probe_chain", "mont_tc",
     "mark_msm_sort", "mark_msm_layout", "mark_msm_scan", "mark_msm_bucket",
     "mark_msm_stream", "mark_msm_done"), 0
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}      # source -> nvcc/ptxas output of its build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise LoadFailed("nvcc not found: the CUDA kernels cannot be built")
    return found


def _gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise LoadFailed("g++ not found: the host codec cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".cpp"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _source_hash() / f"lib{name}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if name in HOST_SOURCES:
            cmd = [_gxx(), *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise LoadFailed("build failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (or .cpp), building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib


def threads_per_lane(source: str, kernel: str) -> int:
    """Threads that compute one lane of `kernel` (a LAUNCHES key) as the
    library of csrc/<source>.cu launches it (its blz_threads_per_lane)."""
    fn = load(source).blz_threads_per_lane
    fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    n = fn(kernel.encode())
    if n < 1:
        raise LoadFailed(f"{source}.cu has no kernel {kernel!r}")
    return n


def check(rc: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise DeviceError(f"{what}: CUDA error {rc}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
