"""The probes of experiments/ (blaze_tpu_torch.experiments) against the JAX
package and Python integers, on the CPU.

The same numpy-seeded limbs go through the plain versions of the port's
probe kernels (experiments/chain.py) and through the JAX bodies the probe
scripts chain inside their pallas_calls, evaluated outside any kernel
(blaze_tpu's ECKernels for BLS12-381's Fq, L = 24, and PallasFieldOps for
bls12_381_fr, L = 16): mont, redc, add_f, sub_f and the mixed-add body by
value mod p (the JAX bodies are lazy, < 2p; the port's canonical, < p),
ks_carry, mm_i8 and qmm_i8 by value mod R (R = 2^(16L) = 2^(32W), so the
Montgomery values are the same).  conv, conv_f32, the three multiply forms
and E5's composite bodies go against Python integers: the JAX conv bodies
mask each 16-bit column without carrying, so their bits depend on the
layout.  E1's plain version goes against blaze_tpu's Field.mul (the check
PallasMont.main makes) at W = 8 and 12.  Chains of M <= 3 steps on a few
dozen lanes; every comparison is exact.  The probe scripts themselves run
at import (and one asserts a TPU), so none is imported here.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.curves import CURVES as REF_CURVES
from blaze_tpu.curves.kernels import ECKernels as RefECKernels
from blaze_tpu.fields import FIELDS as REF_FIELDS, Field as RefField
from blaze_tpu.fields.kernel_ops import PallasFieldOps
from blaze_tpu_torch.curves import CURVES
from blaze_tpu_torch.experiments import failures, run_all
from blaze_tpu_torch.experiments.chain import (
    a_fragments,
    loop_opcodes,
    mont_tc,
    mont_tc_plain,
    op_summary,
    probe_chain,
    probe_chain_plain,
    probe_mixed,
    probe_mixed_plain,
    sass_key,
    tc_columns,
    tc_matrices,
)
from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.fields.kernel_ops import words_to_limbs16

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 48                 # lanes
FIELD_NAMES = ("bls12_381_fq", "bls12_381_fr")   # W = 12 and 8


def rand_ints(bound: int, n: int, seed: int) -> list:
    """n integers uniform in [0, bound) from seeded numpy words, the first
    two bound - 1 and bound - 2."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, (bound.bit_length() + 95) // 32), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % bound for row in words]
    vals[:2] = [bound - 1, bound - 2]
    return vals


def as_words(spec, vals) -> torch.Tensor:
    return torch.as_tensor(np.stack([int_to_words(v, spec.nwords) for v in vals]).view(np.int32))


def ints(words: torch.Tensor) -> list:
    return [words_to_int(r) for r in words.numpy().view(np.uint32)]


def jax_cols(spec, vals):
    """(L, N) u32 16-bit limbs, lanes last, as the probe scripts lay them."""
    limbs = words_to_limbs16(as_words(spec, vals)).numpy().astype(np.uint32)
    return jnp.asarray(limbs.T)


def jax_ints(cols) -> list:
    """Values of (L, N) 16-bit-stride columns (limbs may exceed 16 bits)."""
    arr = np.asarray(cols, dtype=np.uint64)
    return [sum(int(arr[i, j]) << (16 * i) for i in range(arr.shape[0]))
            for j in range(arr.shape[1])]


_REF: dict = {}


def ref_ops(field: str):
    """(JAX field ops, fc) of the probe scripts for `field`: ECKernels
    (lazy) on BLS12-381's Fq, PallasFieldOps (canonical, as
    mul_kernel_bench.py) on bls12_381_fr."""
    if field not in _REF:
        if field == "bls12_381_fq":
            ops = RefECKernels.for_curve(REF_CURVES["bls12_381"], tile=128)
        else:
            ops = PallasFieldOps(REF_FIELDS[field], lazy=False)
        _REF[field] = (ops, [jnp.asarray(c) for c in ops.field_const_arrays()])
    return _REF[field]


def jax_step(field, body, x, b):
    """One step of the JAX body (redc_probe.py's) on (L, N) limbs."""
    ops, fc = ref_ops(field)
    L = ops.L
    if body == "mont":
        return ops._mont_mul(x, b, fc)
    if body == "redc":
        return ops._redc(jnp.pad(x + b, ((0, ops.W - L), (0, 0))), fc)
    if body == "add_f":
        return ops._add_f(x, b)
    if body == "sub_f":
        return ops._sub_f(x, b)
    if body == "carry":
        return ops._ks_carry(x + b)[0]
    raise ValueError(body)


# ------------------------------------------------ field bodies against JAX
@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("body", ["mont", "redc", "add_f", "sub_f", "carry"])
@pytest.mark.parametrize("M", [1, 3])
def test_field_body_equals_the_jax_body(field, body, M):
    spec = FIELDS[field]
    xs, bs = rand_ints(spec.p, N, 1), rand_ints(spec.p, N, 2)
    got = ints(probe_chain_plain(spec, body, as_words(spec, xs), as_words(spec, bs), M))
    x, b = jax_cols(spec, xs), jax_cols(spec, bs)
    for _ in range(M):
        x = jax_step(field, body, x, b)
    want = jax_ints(x)
    mod = spec.r if body == "carry" else spec.p
    assert [v % mod for v in got] == [v % mod for v in want]
    if body != "carry":
        assert all(v < spec.p for v in got)


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("mode", ["mm", "qmm"])
def test_int8_products_equal_the_jax_int8_products(field, mode):
    """mm_i8 and qmm_i8 (mont_tc's two REDC products alone) against
    _dot_exact on the byte planes _redc builds, chained 3 times."""
    spec = FIELDS[field]
    ops, fc = ref_ops(field)
    L, R = ops.L, spec.r
    xs = rand_ints(R, N, 3)
    got = ints(mont_tc_plain(spec, mode, as_words(spec, xs), None, 3))
    vals = xs
    for _ in range(3):
        x = jax_cols(spec, vals)
        if mode == "mm":
            t8 = jnp.concatenate([x & 0xFF, (x >> 8) & 0xFF, x[: L - 1] >> 16], axis=0)
            mc = ops._dot_exact(fc[0], fc[1], t8)
            vals = [v % R for v in jax_ints(mc[:L] + (mc[L:] << 8))]
        else:
            m8 = jnp.concatenate([x & 0xFF, x >> 8], axis=0)
            qc = ops._dot_exact(fc[2], fc[3], m8)
            vals = [v >> (16 * L) for v in jax_ints(qc[: 2 * L] + (qc[2 * L:] << 8))]
    assert got == vals


# --------------------------------------------- bodies against Python ints
def python_step(spec, body, x, b):
    W, R, p = spec.nwords, spec.r, spec.p
    rinv = pow(R, -1, p)
    words = lambda v: [(v >> (32 * j)) & 0xFFFFFFFF for j in range(W)]  # noqa: E731
    join = lambda ws: sum(w << (32 * j) for j, w in enumerate(ws))  # noqa: E731
    if body in ("conv", "conv_f32"):
        t = x * b
        return (t % R) ^ (t >> (32 * W))
    if body == "mul_lo":
        return join([(xw * bw + bw) & 0xFFFFFFFF for xw, bw in zip(words(x), words(b))])
    if body == "mul_hi":
        return join([((xw * bw >> 32) + bw) & 0xFFFFFFFF for xw, bw in zip(words(x), words(b))])
    if body == "mul_wide":
        out = 0
        for j in range(0, W, 2):
            d = (x >> (32 * j)) & ((1 << 64) - 1)
            d = ((d & 0xFFFFFFFF) * ((b >> (32 * j)) & 0xFFFFFFFF) + d) & ((1 << 64) - 1)
            out |= d << (32 * j)
        return out
    if body == "mont11":
        acc = 0
        for i in range(11):
            acc ^= (x ^ i) * b * rinv % p
        return acc
    if body == "glue15":
        return (x + b) % p
    raise ValueError(body)


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("body", ["conv", "conv_f32", "mul_lo", "mul_hi", "mul_wide",
                                  "mont11", "glue15"])
def test_body_equals_python_ints(field, body):
    spec = FIELDS[field]
    bound = spec.p if body in ("mont11", "glue15") else spec.r
    xs, bs = rand_ints(bound, N, 4), rand_ints(spec.p if body == "mont11" else bound, N, 5)
    M = 2
    got = ints(probe_chain_plain(spec, body, as_words(spec, xs), as_words(spec, bs), M))
    want = []
    for x, b in zip(xs, bs):
        for _ in range(M):
            x = python_step(spec, body, x, b)
        want.append(x)
    assert got == want


def test_streams_are_independent_chains():
    """S = 4: stream s of x (rows s N ..) runs against b's rows, as four
    S = 1 chains do."""
    spec = FIELDS["bls12_381_fr"]
    xs = as_words(spec, rand_ints(spec.p, 4 * N, 6))
    b = as_words(spec, rand_ints(spec.p, N, 7))
    got = probe_chain(spec, "mont", xs, b, 2, S=4)
    for s in range(4):
        assert torch.equal(got[s * N:(s + 1) * N],
                           probe_chain(spec, "mont", xs[s * N:(s + 1) * N].contiguous(), b, 2))


# ---------------------------------------------------------------- E1
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_tensor_core_product_equals_the_jax_field_mul(field):
    spec = FIELDS[field]
    xs, bs = rand_ints(spec.p, N, 8), rand_ints(spec.p, N, 9)
    got = ints(mont_tc_plain(spec, "mont", as_words(spec, xs), as_words(spec, bs), 1))
    F = RefField(REF_FIELDS[field])
    want = jax_ints(F.mul(jax_cols(spec, xs).T, jax_cols(spec, bs).T).T)
    assert got == want
    got3 = ints(mont_tc(spec, "mont", as_words(spec, xs), as_words(spec, bs), 3))
    rinv = pow(spec.r, -1, spec.p)
    assert got3 == [x * b ** 3 * rinv ** 3 % spec.p for x, b in zip(xs, bs)]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_tensor_core_column_sums_stay_exact(field):
    """The s32 column sums of both products at the largest inputs (every
    byte 255; t = (p-1)^2) stay below 2^31 (below 4W 255^2 < 2^23), and
    their 16-bit-position pairs too, as the carry passes need."""
    spec = FIELDS[field]
    W, L = spec.nwords, spec.nlimbs
    top = torch.full((1, L), 0xFFFF, dtype=torch.int64)
    bound = 4 * W * 255 * 255
    for which in ("n", "p"):
        cols = tc_columns(spec, top, which)
        assert int(cols.max()) <= bound < 2 ** 23
        assert int((cols[..., 0::2] + (cols[..., 1::2] << 8)).max()) < 2 ** 31
    pm1 = as_words(spec, [spec.p - 1])
    assert ints(mont_tc_plain(spec, "mont", pm1, pm1)) == [
        (spec.p - 1) ** 2 * pow(spec.r, -1, spec.p) % spec.p]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_a_fragments_follow_the_m16n8k32_layout(field):
    """Every byte of N and P sits where the PTX ISA's A fragment of
    mma.m16n8k32 (u8) puts it: lane 4g + t, register 0 row g bytes 4t..,
    1 row g + 8, 2 row g bytes 16 + 4t.., 3 row g + 8."""
    spec = FIELDS[field]
    for mat in tc_matrices(spec):
        frags = a_fragments(mat)
        KT = -(-mat.shape[1] // 32)
        rebuilt = np.zeros((16 * (-(-mat.shape[0] // 16)), 32 * KT), dtype=np.int64)
        for tile in range(frags.shape[0]):
            r, c = divmod(tile, KT)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for reg, (row, col) in enumerate(((g, 4 * t), (g + 8, 4 * t),
                                                  (g, 16 + 4 * t), (g + 8, 16 + 4 * t))):
                    word = int(frags[tile, lane, reg])
                    for i in range(4):
                        rebuilt[16 * r + row, 32 * c + col + i] = (word >> (8 * i)) & 0xFF
        assert np.array_equal(rebuilt[: mat.shape[0], : mat.shape[1]], mat)
        assert not rebuilt[mat.shape[0]:].any() and not rebuilt[:, mat.shape[1]:].any()


# ---------------------------------------------------------------- E5
@pytest.mark.parametrize("M", [1, 2])
def test_mixed_add_body_equals_the_jax_body(M):
    curve = CURVES["bls12_381"]
    spec = curve.fq
    W = spec.nwords
    vals = [rand_ints(spec.p, N, 10 + k) for k in range(5)]
    p = torch.cat([as_words(spec, v).t() for v in vals[:3]]).contiguous()
    q = torch.cat([as_words(spec, v).t() for v in vals[3:]]).contiguous()
    got = probe_mixed(curve, p, q, M)
    assert torch.equal(got, probe_mixed_plain(curve, p, q, M))
    kern, fc = ref_ops("bls12_381_fq")
    b3c = (jnp.asarray(kern._b3m_i8), jnp.asarray(kern._b3_corr))
    X1, Y1, Z1, X2, Y2 = (jax_cols(spec, v) for v in vals)
    for _ in range(M):
        X1, Y1, Z1 = kern._add_mixed_body(X1, Y1, Z1, X2, Y2, fc, b3c)
    for k, ref in enumerate((X1, Y1, Z1)):
        mine = [v % spec.p for v in ints(got[k * W:(k + 1) * W].t().contiguous())]
        assert mine == [v % spec.p for v in jax_ints(ref)]


# ----------------------------------------------------------- plumbing
def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = FIELDS["bls12_381_fr"]
    x = as_words(spec, rand_ints(spec.p, 8, 11))
    with pytest.raises(ValueError):
        probe_chain(spec, "sub_f", torch.cat([x] * 4), x, 1, S=4)   # built for S = 1
    with pytest.raises(ValueError):
        probe_chain(spec, "nope", x, x, 1)
    with pytest.raises(ValueError):
        probe_chain(spec, "mont", x[:4], x, 1)                    # not S streams of b
    with pytest.raises(ValueError):
        mont_tc(spec, "mont", x)                                  # no b
    with pytest.raises(ValueError):
        mont_tc(spec, "mont", x.to(torch.int64), x)


SASS = """
        Function : _Z18probe_chain_kernelILi8ELi0ELi4EEvPKjS1_Pjlin3blz11FieldConstsIXT_EEE
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   IMAD R3, R4, R5, RZ ;
        /*0020*/                   IMAD.HI.U32 R6, R4, R5, RZ ;
        /*0030*/                   IADD3 R7, P0, R3, R6, RZ ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
        Function : _Z14mont_tc_kernelILi12ELi0EEvPKjS1_PjliPK5uint4S5_N3blz11FieldConstsIXT_EEE
        /*0000*/                   IMMA.16832.U8.U8 R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
"""


def test_loop_opcodes_reads_the_step_loop():
    ops = loop_opcodes(SASS)
    assert sass_key("_Z18probe_chain_kernelILi8ELi0ELi4EEv") == ("probe_chain", 8, 0, 4)
    s = op_summary(ops[("probe_chain", 8, 0, 4)])
    assert (s["imad"], s["imad_lo"], s["imad_hi"], s["iadd3"], s["total"]) == (2, 1, 1, 1, 4)
    assert s["fma_slots"] == 3                  # IMAD.HI takes two of the FMA pipe's slots
    assert op_summary(ops[("mont_tc", 12, 0)])["imma"] == 1


def test_run_all_on_the_cpu_checks_every_probe():
    recs = run_all("cpu", cut=True, lanes=16)
    assert {r["probe"] for r in recs} == {"E1", "E2", "E3", "E4", "E5"}
    assert not failures(recs)
    assert all(r["ms"] is None for r in recs)          # nothing timed on the CPU


def test_main_without_a_card_exits_nonzero_and_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "-m", "blaze_tpu_torch.experiments"], env=env,
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA device" in out.stderr
    code = ("import runpy, sys\n"
            "sys.argv = ['x', '--device', 'cpu', '--only', 'E2,E5', '--lanes', '8', '--cut']\n"
            "try:\n"
            "    runpy.run_module('blaze_tpu_torch.experiments', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'blaze_tpu.', 'experiments'))\n"
            "               or m == 'blaze_tpu' for m in sys.modules)\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "cpu" and json.loads(lines[-1]) == {"e5_shares": None}
    assert {json.loads(x)["probe"] for x in lines[:-2]} == {"E2", "E5"}
