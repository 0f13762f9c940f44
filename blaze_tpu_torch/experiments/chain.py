"""The probe kernels' wrappers, their plain versions and the slope timer.

Three kernels, built by _build.py like the others:

  * `probe_chain` (csrc/probe_chain.cu): M dependent steps x <- body(x, b)
    of one of the bodies in BODIES (csrc/probe.cuh), one lane per thread,
    S independent streams per thread; the E2-E5 probes.
  * `probe_mixed` (csrc/probe_chain.cu, the same launch counter): E5's
    mixed-add body M times per lane on ec_team.cuh's team of six.
  * `mont_tc` (csrc/mont_tc.cu): the Montgomery product whose REDC runs on
    the int8 tensor cores (E1), and its two matrix products alone (E2's
    mm_i8, qmm_i8).

Each wrapper launches its kernel for CUDA tensors (and adds one to its
launch counter, `_build.LAUNCHES`) and runs the plain version beside it,
the same function on int64 16-bit limbs (fields/kernel_ops.py), only for
CPU tensors.  Elements are (N, W) int32 words.

`slope_ms` times a run at two chain lengths (bench.profile.cuda_ms: CUDA
events behind a spin of the card): the slope separates a step's cost
from the launch.  `loop_opcodes` reads a built kernel's SASS (cuobjdump)
and counts the opcodes of its step loop.
"""
from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..curves.ops import b3_mont, rcb_add_mixed
from ..curves.spec import CurveSpec
from ..fields.kernel_ops import (
    PlainFieldOps,
    conv_cols,
    cond_sub,
    consts_host,
    field_consts,
    limbs16_to_words,
    normalize,
    words_to_limbs16,
)
from ..fields.spec import FieldSpec

# csrc/probe.cuh's Body enum, in order
BODIES = ("mont", "conv", "carry", "redc", "add_f", "sub_f", "mul_lo", "mul_hi",
          "mul_wide", "conv_f32", "mont11", "glue15", "mont_hi", "mont_rz", "mont_comba",
          "mont_split", "mont_wide", "mont_pair64")
# the forms of the canonical product x b / R mod p: K0's (mont) and the others
# probe.cuh keeps beside it
PRODUCT_BODIES = ("mont", "mont_hi", "mont_rz", "mont_comba", "mont_split", "mont_wide",
                  "mont_pair64")
# the bodies built with S = 4 streams per thread too (probe_chain.cu chain_w)
STREAM_BODIES = ("mont", "conv", "redc", "add_f", "mul_lo", "mul_hi", "mul_wide")
TC_MODES = ("mont", "mm", "qmm")          # csrc/mont_tc.cu's Mode enum
MMA_OPS = 16 * 8 * 32 * 2                 # integer operations of one m16n8k32 mma

_c = ctypes
_ARGTYPES = {
    "blz_probe_chain": [_c.c_int, _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                        _c.c_void_p, _c.c_int64, _c.c_int, _c.c_void_p],
    "blz_probe_mixed": [_c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                        _c.c_int64, _c.c_int, _c.c_void_p],
    "blz_mont_tc": [_c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                    _c.c_void_p, _c.c_int64, _c.c_int, _c.c_void_p],
}
_M32 = (1 << 32) - 1
_M16 = (1 << 16) - 1


def _entry(source: str, name: str):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(source: str, name: str, counter: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(source, name)(*args, stream)
    _build.check(rc, name)
    _build.LAUNCHES[counter] += 1


def _check_words(x: torch.Tensor, W: int, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != W:
        raise ValueError(f"{what}: want (N, {W}) int32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


_OPS: dict = {}


def _ops(spec: FieldSpec, lazy: bool = False) -> PlainFieldOps:
    key = (spec.name, lazy)
    if key not in _OPS:
        _OPS[key] = PlainFieldOps(spec, lazy=lazy)
    return _OPS[key]


# ----------------------------------------------------------- plain bodies
def _words64(x: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., L/2) int64 words in [0, 2^32)."""
    return x[..., 0::2] | (x[..., 1::2] << 16)


def _limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., W) int64 words -> (..., 2W) 16-bit limbs."""
    return torch.stack([w & _M16, w >> 16], dim=-1).reshape(*w.shape[:-1], 2 * w.shape[-1])


def _mul32(x: torch.Tensor, b: torch.Tensor):
    """(lo, hi) 32-bit halves of x b for int64 words below 2^32, exact in
    int64 (16-bit halves)."""
    xl, xh, bl, bh = x & _M16, x >> 16, b & _M16, b >> 16
    mid = xh * bl + xl * bh                       # < 2^33
    low = xl * bl
    lo = (low + ((mid & _M16) << 16)) & _M32
    hi = xh * bh + (((mid << 16) + low) >> 32)
    return lo, hi


def _full_product(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 2L limbs of x b (x, b < R)."""
    return normalize(conv_cols(x, b, 2 * x.shape[-1]), 16)[0]


def plain_step(spec: FieldSpec, body: str, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One step x <- body(x, b) on (..., L) int64 16-bit limbs: what
    csrc/probe.cuh's body computes, value for value."""
    L = spec.nlimbs
    ops = _ops(spec)
    if body in PRODUCT_BODIES:
        return ops.mul(x, b)
    if body in ("conv", "conv_f32"):
        t = _full_product(x, b)
        return t[..., :L] ^ t[..., L:]
    if body == "carry":
        return normalize(x + b, 16)[0]
    if body == "redc":
        t, top = normalize(x + b, 16)
        zeros = torch.zeros_like(t)
        return ops.redc_sum(torch.cat([t, top[..., None], zeros], dim=-1), 1)
    if body == "add_f":
        return ops.add(x, b)
    if body == "sub_f":
        return ops.sub(x, b)
    if body in ("mul_lo", "mul_hi"):
        xw, bw = _words64(x), _words64(b)
        lo, hi = _mul32(xw, bw)
        return _limbs(((lo if body == "mul_lo" else hi) + bw) & _M32)
    if body == "mul_wide":
        xw, bw = _words64(x), _words64(b)
        lo, hi = xw[..., 0::2], xw[..., 1::2]
        plo, phi = _mul32(lo, bw[..., 0::2])
        s = plo + lo
        nlo, nhi = s & _M32, (phi + hi + (s >> 32)) & _M32
        return _limbs(torch.stack([nlo, nhi], dim=-1).reshape(xw.shape))
    if body == "mont11":
        acc = torch.zeros_like(x)
        for i in range(11):
            y = x.clone()
            y[..., 0] ^= i
            acc = acc ^ ops.mul(y, b)
        return acc
    if body == "glue15":
        for _ in range(8):
            x = ops.add(x, b)
        for _ in range(7):
            x = ops.sub(x, b)
        return x
    raise ValueError(f"no probe body {body!r}")


# ------------------------------------------------------------ probe_chain
def probe_chain_plain(spec: FieldSpec, body: str, x: torch.Tensor, b: torch.Tensor, M: int,
                      S: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `probe_chain`."""
    xl = words_to_limbs16(x)
    bl = words_to_limbs16(b).repeat(S, 1)
    for _ in range(M):
        xl = plain_step(spec, body, xl, bl)
    return limbs16_to_words(xl)


def probe_chain(spec: FieldSpec, body: str, x: torch.Tensor, b: torch.Tensor, M: int,
                S: int = 1) -> torch.Tensor:
    """M dependent steps x <- body(x, b): x (S N, W) int32 words (stream s
    at rows s N .. s N + N - 1), b (N, W).  Returns (S N, W)."""
    W = spec.nwords
    _check_words(x, W, "x")
    _check_words(b, W, "b")
    if body not in BODIES:
        raise ValueError(f"no probe body {body!r} (have {BODIES})")
    if S not in (1, 4) or (S == 4 and body not in STREAM_BODIES):
        raise ValueError(f"{body}: built for S = 1" + (", 4" if body in STREAM_BODIES else ""))
    if x.shape[0] != S * b.shape[0] or x.device != b.device:
        raise ValueError(f"x {tuple(x.shape)} is not S = {S} streams of b {tuple(b.shape)} "
                         "on its device")
    if M < 0:
        raise ValueError("M must be >= 0")
    if x.device.type == "cpu":
        return probe_chain_plain(spec, body, x, b, M, S)
    out = torch.empty_like(x)
    if b.shape[0]:
        _launch("probe_chain", "blz_probe_chain", "probe_chain", x.device, W,
                BODIES.index(body), S, field_consts(spec).ctypes.data, x.data_ptr(),
                b.data_ptr(), out.data_ptr(), b.shape[0], M)
    return out


# ------------------------------------------------------------ probe_mixed
_CURVE_CONSTS: dict = {}


def probe_mixed_plain(curve: CurveSpec, p: torch.Tensor, q: torch.Tensor, M: int) -> torch.Tensor:
    """Plain PyTorch version of `probe_mixed`: RCB alg 8 on the lazy
    16-bit-limb twin of field.cuh (curves/ops.py rcb_add_mixed)."""
    W = curve.fq.nwords
    ops = _ops(curve.fq, lazy=True)
    co = [words_to_limbs16(p[k * W:(k + 1) * W].t()) for k in range(3)]
    x2, y2 = (words_to_limbs16(q[k * W:(k + 1) * W].t()) for k in range(2))
    b3 = ops.const(b3_mont(curve), p.device)
    for _ in range(M):
        co = rcb_add_mixed(ops, b3, *co, x2, y2)
    return torch.cat([limbs16_to_words(c).t() for c in co]).contiguous()


def probe_mixed(curve: CurveSpec, p: torch.Tensor, q: torch.Tensor, M: int) -> torch.Tensor:
    """E5's mixed-add body M times per lane: p (3W, B) projective, q (2W, B)
    affine, int32 words lanes-major (K2's rows), values < 2p.  Returns the
    (3W, B) point after M adds of q."""
    W = curve.fq.nwords
    for x, rows, what in ((p, 3 * W, "p"), (q, 2 * W, "q")):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != rows:
            raise ValueError(f"{what}: want ({rows}, B) int32, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: not contiguous")
    if p.shape[1] != q.shape[1] or p.device != q.device:
        raise ValueError("p and q differ in lanes or device")
    if p.device.type == "cpu":
        return probe_mixed_plain(curve, p, q, M)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    consts = _CURVE_CONSTS.get(curve.name)
    if consts is None:
        consts = _CURVE_CONSTS[curve.name] = consts_host(curve.fq, b3_mont(curve))
    out = torch.empty_like(p)
    if p.shape[1]:
        _launch("probe_chain", "blz_probe_mixed", "probe_chain", p.device, W,
                consts.ctypes.data, p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[1], M)
    return out


# ---------------------------------------------------------------- mont_tc
def _bytes_of(value: int, n: int) -> np.ndarray:
    return np.frombuffer(value.to_bytes(n, "little"), dtype=np.uint8).astype(np.int64)


_MATS: dict = {}


def tc_matrices(spec: FieldSpec) -> tuple:
    """mont_tc.cu's constant byte Toeplitz matrices (int64 numpy): N (4W,
    4W), N[k][j] = byte k-j of n' = -p^-1 mod R; P (8W, 4W), P[k][j] =
    byte k-j of p (zero outside 0 <= k-j < 4W)."""
    mats = _MATS.get(spec.name)
    if mats is None:
        nb = 4 * spec.nwords
        npb, pb = _bytes_of(spec.nprime, nb), _bytes_of(spec.p, nb)
        k, j = np.meshgrid(np.arange(2 * nb), np.arange(nb), indexing="ij")
        d = k - j
        ok = (d >= 0) & (d < nb)
        P = np.where(ok, pb[np.clip(d, 0, nb - 1)], 0)
        N = np.where(ok, npb[np.clip(d, 0, nb - 1)], 0)[:nb]
        mats = _MATS[spec.name] = (N, P)
    return mats


def a_fragments(mat: np.ndarray) -> np.ndarray:
    """The A fragments of mma.m16n8k32 (u8, row-major A) of every 16 x 32
    tile of `mat` (rows padded to 16, columns to 32), tile (r, c) at
    index r * KT + c: (tiles, 32 lanes, 4) uint32.  Lane l (g = l / 4,
    t = l % 4) holds in register 0 bytes 4t..4t+3 of row g, in 1 those of
    row g + 8, in 2 bytes 16+4t..16+4t+3 of row g, in 3 those of row g + 8;
    the first byte in the low bits."""
    R, KT = -(-mat.shape[0] // 16), -(-mat.shape[1] // 32)
    pad = np.zeros((16 * R, 32 * KT), dtype=np.int64)
    pad[: mat.shape[0], : mat.shape[1]] = mat
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((R * KT, 32, 4), dtype=np.uint32)
    for r in range(R):
        for c in range(KT):
            tile = pad[16 * r:16 * r + 16, 32 * c:32 * c + 32]
            for reg, (row, col) in enumerate(((g, 4 * t), (g + 8, 4 * t), (g, 16 + 4 * t),
                                              (g + 8, 16 + 4 * t))):
                v = np.zeros(32, dtype=np.uint64)
                for i in range(4):
                    v |= tile[row, col + i].astype(np.uint64) << np.uint64(8 * i)
                out[r * KT + c, :, reg] = v.astype(np.uint32)
    return out


def tc_fragments(spec: FieldSpec) -> np.ndarray:
    """N's fragments then P's (a_fragments), the block blz_mont_tc takes."""
    N, P = tc_matrices(spec)
    return np.concatenate([a_fragments(N), a_fragments(P)])


def _bytes16(x: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., 2L) bytes, low byte first."""
    return torch.stack([x & 0xFF, x >> 8], dim=-1).reshape(*x.shape[:-1], 2 * x.shape[-1])


_DMATS: dict = {}


def tc_columns(spec: FieldSpec, x: torch.Tensor, which: str) -> torch.Tensor:
    """The column sums the tensor cores make: N (which "n") or P ("p")
    times the 4W bytes of the (..., L) limbs x, exact (float64 sums below
    2^53), as int64 (..., 4W) or (..., 8W)."""
    key = (spec.name, which, str(x.device))
    mat = _DMATS.get(key)
    if mat is None:
        mat = tc_matrices(spec)[0 if which == "n" else 1]
        mat = _DMATS[key] = torch.as_tensor(mat.T.astype(np.float64), device=x.device)
    return (_bytes16(x).double() @ mat).long()


def _cols16(cols: torch.Tensor) -> torch.Tensor:
    """Byte-position column sums -> 16-bit-position sums (below 2^31)."""
    return cols[..., 0::2] + (cols[..., 1::2] << 8)


def tc_step(spec: FieldSpec, mode: str, x: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """One step of mont_tc.cu on (..., L) int64 16-bit limbs, its arithmetic
    step for step: mont x b / R mod p, mm x n' mod R, qmm floor(x p / R)."""
    L = spec.nlimbs
    if mode == "mm":
        return normalize(_cols16(tc_columns(spec, x, "n")), 16)[0]
    if mode == "qmm":
        return normalize(_cols16(tc_columns(spec, x, "p")), 16)[0][..., L:]
    t = _full_product(x, b)
    m = normalize(_cols16(tc_columns(spec, t[..., :L], "n")), 16)[0]
    u, top = normalize(t + _cols16(tc_columns(spec, m, "p")), 16)
    return cond_sub(u[..., L:], top, _ops(spec).const(spec.p, x.device), 16)


def mont_tc_plain(spec: FieldSpec, mode: str, a: torch.Tensor, b: torch.Tensor | None,
                  M: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `mont_tc`."""
    x = words_to_limbs16(a)
    y = None if b is None else words_to_limbs16(b)
    for _ in range(M):
        x = tc_step(spec, mode, x, y)
    return limbs16_to_words(x)


_FRAGS: dict = {}


def mont_tc(spec: FieldSpec, mode: str, a: torch.Tensor, b: torch.Tensor | None = None,
            M: int = 1) -> torch.Tensor:
    """M dependent steps of mont_tc.cu on (N, W) int32 words: mode "mont"
    x <- x b / R mod p (canonical for a, b < p; b (N, W)), "mm" x <- x n'
    mod R, "qmm" x <- floor(x p / R) (b unused).  The card must be sm_90 or
    later; any other raises."""
    W = spec.nwords
    if mode not in TC_MODES:
        raise ValueError(f"no mont_tc mode {mode!r} (have {TC_MODES})")
    _check_words(a, W, "a")
    if mode == "mont":
        if b is None:
            raise ValueError("mode mont needs b")
        _check_words(b, W, "b")
        if b.shape != a.shape or b.device != a.device:
            raise ValueError("operands differ in shape or device")
    if M < 0:
        raise ValueError("M must be >= 0")
    if a.device.type == "cpu":
        return mont_tc_plain(spec, mode, a, b if mode == "mont" else None, M)
    cap = torch.cuda.get_device_capability(a.device)
    if cap < (9, 0):
        raise RuntimeError(f"mont_tc is built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    key = (spec.name, str(a.device))
    frags = _FRAGS.get(key)
    if frags is None:
        frags = _FRAGS[key] = torch.as_tensor(tc_fragments(spec).view(np.int32),
                                              device=a.device)
    out = torch.empty_like(a)
    if a.shape[0]:
        _launch("mont_tc", "blz_mont_tc", "mont_tc", a.device, W, TC_MODES.index(mode),
                field_consts(spec).ctypes.data, frags.data_ptr(), a.data_ptr(),
                (b if mode == "mont" else a).data_ptr(), out.data_ptr(), a.shape[0], M)
    return out


# ----------------------------------------------------------------- timing
def slope_ms(run, m_lo: int, m_hi: int, reps: int, device) -> dict:
    """run(M) timed at M = m_lo and m_hi in the order lo, hi, hi, lo (CUDA
    events behind a spin of the card, `reps` launches each), the best of
    each: {"ms": [lo, hi], "step_ms": slope per step}.  On the CPU
    (device not a card) each runs once and nothing is timed."""
    t = {m_lo: [], m_hi: []}
    for m in (m_lo, m_hi, m_hi, m_lo):
        t[m].append(timed_ms(lambda: run(m), device, reps))
    if t[m_lo][0] is None:
        return {"ms": None, "step_ms": None}
    lo, hi = min(t[m_lo]), min(t[m_hi])
    return {"ms": [lo, hi], "step_ms": (hi - lo) / (m_hi - m_lo)}


# ------------------------------------------------------------------- SASS
_KEY = re.compile(r"(probe_chain_mixed_kernel|probe_chain_kernel|mont_tc_kernel)"
                  r"ILi(\d+)E(?:Li(\d+)E)?(?:Li(\d+)E)?")
_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_key(mangled: str):
    """('probe_chain', W, body, S), ('probe_chain_mixed', W) or ('mont_tc',
    W, mode) of a mangled kernel name, None for another function."""
    m = _KEY.search(mangled)
    if not m:
        return None
    name = m.group(1).removesuffix("_kernel")
    return (name, *(int(v) for v in m.groups()[1:] if v is not None))


def loop_opcodes(sass: str) -> dict:
    """{sass_key: Counter of the opcodes in the kernel's step loop} from
    cuobjdump -sass output: the span of its widest backward branch (the
    M loop; the whole kernel where it has none)."""
    funcs, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = sass_key(line)
            if key:
                funcs[key] = []
        elif key:
            m = _INSN.match(line)
            if m:
                funcs[key].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for key, insns in funcs.items():
        lo, hi = 0, len(insns)
        best = -1
        for i, (addr, op, rest) in enumerate(insns):
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and tgt:
                dest = int(tgt.group(1), 16)
                if dest < addr and addr - dest > best:
                    best = addr - dest
                    lo = next(k for k, x in enumerate(insns) if x[0] >= dest)
                    hi = i + 1
        out[key] = collections.Counter(op for _, op, _ in insns[lo:hi])
    return out


def sass_of(source: str) -> str | None:
    """cuobjdump -sass of the built library csrc/<source>.cu, None without
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    _build.load(source)
    return subprocess.run([tool, "-sass", str(_build._lib_path(source))], capture_output=True,
                          text=True, check=True).stdout


def registers(key: tuple) -> int | None:
    """The registers ptxas gave the kernel `key` (sass_key's form), from
    its library's build log in this process; None where the library was
    built before (or not at all)."""
    log = _build.BUILD_LOG.get("mont_tc" if key[0] == "mont_tc" else "probe_chain", "")
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = sass_key(line)
        elif current == key and "Used" in line and "registers" in line:
            return int(line.split("Used")[1].split()[0])
    return None


# the integer ALU pipe's opcodes (IADD3 and IADD3.X, LOP3, SEL, ISETP,
# shifts, MOV); IMAD.MOV goes to the FMA pipe, uniform (U*) ops to neither
ALU_OPS = ("IADD3", "LOP3", "SEL", "ISETP", "SHF", "LEA", "MOV", "IMNMX", "PLOP3")


def op_summary(ops: collections.Counter) -> dict:
    """The families of a step's opcodes that its records read: every IMAD
    form (the FMA pipe's integer issue, IMAD.MOV included), the FMA pipe's
    slots, the three multiply forms, IMMA, FFMA, IADD3, the ALU pipe's
    operations (ALU_OPS) and the total."""
    def count(pred):
        return sum(v for k, v in ops.items() if pred(k))

    return {"imad": count(lambda k: k.startswith("IMAD")),
            # the FMA pipe's issue slots: IMAD.HI and IMAD.WIDE take two
            # (both run at half IMAD's rate, PERF.md §6)
            "fma_slots": count(lambda k: k.startswith("IMAD"))
            + count(lambda k: k.startswith(("IMAD.HI", "IMAD.WIDE"))),
            "imad_lo": count(lambda k: k.startswith("IMAD") and not any(
                s in k for s in (".HI", ".WIDE", ".MOV", ".SHL", ".X", ".IADD"))),
            "imad_hi": count(lambda k: k.startswith("IMAD.HI")),
            "imad_wide": count(lambda k: k.startswith("IMAD.WIDE")),
            "imad_x": count(lambda k: k.startswith("IMAD.X")),
            "imad_mov": count(lambda k: k.startswith("IMAD.MOV")),
            "imma": count(lambda k: k.startswith("IMMA")),
            "ffma": count(lambda k: k.startswith("FFMA")),
            "iadd3": count(lambda k: k.startswith("IADD3")),
            "alu": count(lambda k: k.split(".")[0] in ALU_OPS),
            "total": sum(ops.values())}


# ---------------------------------------------------------------- records
_SASS: dict = {}


def step_ops(key: tuple) -> dict | None:
    """op_summary of the step loop of the built kernel `key` (sass_key's
    form), None without cuobjdump; one cuobjdump per library."""
    source = "mont_tc" if key[0] == "mont_tc" else "probe_chain"
    if source not in _SASS:
        text = sass_of(source)
        _SASS[source] = None if text is None else loop_opcodes(text)
    table = _SASS[source]
    return None if table is None or key not in table else op_summary(table[key])


def rates(step_ms: float | None, elem_ops: int, ops: dict | None, per_thread: int,
          per_warp: int, sol) -> dict:
    """A step's cost and attainment: `elem_ops` element operations per step
    (lanes times streams), `ops` the step loop's opcodes, issued once per
    thread for `per_thread` element operations and IMMA once per warp for
    `per_warp`.  On the CPU (step_ms None) the times are not measured."""
    out = {"ns_per_elem_op": None, "g_elem_ops_per_s": None}
    if ops is not None:
        out["imad_per_elem_op"] = ops["imad"] / per_thread
        out["imma_per_elem_op"] = ops["imma"] / per_warp
        # the step's least time at the IMAD rate (its IMAD-family issue)
        out["imad_bound_step_ms"] = out["imad_per_elem_op"] * elem_ops / sol.imad_per_s * 1e3
        out["fma_slots_per_elem_op"] = ops["fma_slots"] / per_thread
    if step_ms is None or step_ms <= 0:
        return out
    rate = elem_ops / (step_ms * 1e-3)
    out.update(ns_per_elem_op=step_ms * 1e6 / elem_ops, g_elem_ops_per_s=rate / 1e9)
    if ops is not None:
        out["imad_fraction"] = out["imad_per_elem_op"] * rate / sol.imad_per_s
        out["fma_pipe_fraction"] = out["fma_slots_per_elem_op"] * rate / sol.imad_per_s
        if ops["imma"] and sol.int8_tc_ops_per_s:
            out["tc_fraction"] = out["imma_per_elem_op"] * MMA_OPS * rate / sol.int8_tc_ops_per_s
    return out


def timed_ms(fn, device, reps: int) -> float | None:
    """bench.profile.cuda_ms on the card; None (not measured) on the CPU,
    where fn runs once."""
    from ..bench.profile import cuda_ms

    if torch.device(device).type != "cuda":
        fn()
        return None
    return cuda_ms(fn, reps)


def plain_timed(fn, device) -> tuple:
    """(fn(), host ms of the call, synchronised on the card): a plain
    version's one call, on the lanes it checks."""
    import time

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two word tensors as unsigned 32-bit words."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = ((a.to(torch.int64) & _M32) - (b.to(torch.int64) & _M32)).abs()
    return int(d.max()) if d.numel() else 0


def stream_prefix(x: torch.Tensor, S: int, k: int) -> torch.Tensor:
    """The first k lanes of each of the S streams of x (S N, W)."""
    n = x.shape[0] // S
    return torch.cat([x[s * n:s * n + k] for s in range(S)]).contiguous()


def tc_work(spec: FieldSpec, n: int, M: int = 1) -> tuple:
    """(bytes, IMADs, tensor-core ops) of M products of mont_tc on n
    elements: a, b read and the product written once; 2W^2 IMADs of the
    convolution per product (W^2 low and W^2 high halves); the byte MACs of
    N (lower triangle, 4W(4W+1)/2) and P (4W x 4W), 2 operations each."""
    W = spec.nwords
    d = 4 * W
    return 3 * n * W * 4, M * n * 2 * W * W, M * n * 2 * (d * (d + 1) // 2 + d * d)


def work_bound(work: tuple, sol) -> tuple:
    """(least ms, "bytes" or "operations") of (bytes, IMADs, int8 ops): the
    largest of the bytes over HBM bandwidth, the IMADs over the IMAD rate
    and the int8 operations over the tensor cores' rate."""
    nbytes, imads, tc = work
    t_bytes = nbytes / sol.hbm_bytes_per_s * 1e3
    t_tc = tc / sol.int8_tc_ops_per_s if tc and sol.int8_tc_ops_per_s else 0.0
    t_ops = max(imads / sol.imad_per_s, t_tc) * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def measure_chain(probe: str, spec: FieldSpec, bodies, lanes: int, ms: tuple, device,
                  S: int = 1, reps: int = 3, check_lanes: int | None = 512,
                  seed: int = 1, long_ms: tuple | None = None) -> list:
    """One record per (name, port body[, long]) of `bodies`: the body
    chained at the two lengths `ms` (`long_ms`, where given, for the bodies
    marked long) on `lanes` lanes x S streams of canonical operands from
    the seed, its cost per step (the slope), its step's opcodes (SASS),
    its kernel's registers and its rates, and its output at the longer
    chain held against its plain version on the first `check_lanes` lanes
    of each stream (all with None).  A port body "tc:mm" or "tc:qmm" is a
    mont_tc mode (S = 1).  A cheap body's 128 steps cost less than the
    launch's memory traffic, under which they hide: its slope needs the
    long chain."""
    from ..bench.profile import device_kind, speed_of_light
    from ..oracle.gen import rand_words

    W = spec.nwords
    dev = torch.device(device)
    sol = speed_of_light(device_kind(dev))
    x = rand_words(spec, (S * lanes, W), seed, dev)
    b = rand_words(spec, (lanes, W), seed + 1, dev)
    k = lanes if check_lanes is None else min(check_lanes, lanes)
    recs = []
    for name, body, *long in bodies:
        steps = long_ms if long and long_ms else ms
        if body.startswith("tc:"):
            mode = body[3:]

            def run(M, mode=mode):
                return mont_tc(spec, mode, x, None, M)

            def plain(M, mode=mode):
                return mont_tc_plain(spec, mode, x[:k], None, M)

            key, per_thread, per_warp = ("mont_tc", W, TC_MODES.index(mode)), 1, 32
        else:
            def run(M, body=body):
                return probe_chain(spec, body, x, b, M, S)

            def plain(M, body=body):
                return probe_chain_plain(spec, body, stream_prefix(x, S, k), b[:k], M, S)

            key, per_thread, per_warp = ("probe_chain", W, BODIES.index(body), S), S, 32 * S
        sl = slope_ms(run, steps[0], steps[1], reps, dev)
        want, plain_ms = plain_timed(lambda: plain(steps[1]), dev)
        err = max_err(stream_prefix(run(steps[1]), S, k), want)
        ops = step_ops(key) if dev.type == "cuda" else None
        recs.append({"probe": probe, "body": name, "port_body": body, "field": spec.name,
                     "W": W, "lanes": lanes, "S": S, "M": list(steps), "ms": sl["ms"],
                     "step_ms": sl["step_ms"], "registers": registers(key),
                     **rates(sl["step_ms"], S * lanes, ops, per_thread, per_warp, sol),
                     "sass": ops, "checked_lanes": k, "plain_ms": plain_ms,
                     "max_abs_err": err})
    return recs
