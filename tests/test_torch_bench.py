"""The port's benchmark module (blaze_tpu_torch/bench/) on the CPU.

scaling_efficiency against blaze_tpu's; bench_kernel's CPU timing and its
summary; speed_of_light refusing a card it does not know; the bound column
of PERF.md's kernel table reproduced from the H100's SOL_TABLE row at each
kernel's main shape (and equal to the values chip_smoke.py printed before
the bounds moved to bench/profile.py); the work counts; the microbench's
spot check; the instance generator and ECOracle.mul against their slow
forms.
"""
import math
import random
import re

import numpy as np
import pytest
import torch

from blaze_tpu.bench import profile as jax_profile
from blaze_tpu_torch.bench import microbench
from blaze_tpu_torch.bench.profile import (
    SOL_TABLE,
    bench_kernel,
    field_mul_traffic_bytes,
    fp2_product_imads,
    kernel_work,
    msm_work,
    ntt_work,
    pipeline_work,
    poseidon_work,
    scaling_efficiency,
    speed_of_light,
    work_bound_ms,
)
from blaze_tpu_torch.curves import CURVES, G1_CURVES
from blaze_tpu_torch.fields import FIELDS
from blaze_tpu_torch.hash import generate_params
from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
from blaze_tpu_torch.oracle.gen import subgroup_msm_instance

H100 = SOL_TABLE["NVIDIA H100 80GB HBM3"]
CPU = SOL_TABLE["cpu"]


@pytest.mark.parametrize("by_n", [{1: 10.0}, {1: 10.0, 2: 19.0, 4: 30.0},
                                  {4: 33.0, 1: 9.0, 8: 60.0}])
def test_scaling_efficiency_matches_the_jax_version(by_n):
    assert scaling_efficiency(by_n) == jax_profile.scaling_efficiency(by_n)


def test_scaling_efficiency_needs_the_one_device_entry():
    for fn in (scaling_efficiency, jax_profile.scaling_efficiency):
        with pytest.raises(ValueError):
            fn({2: 10.0, 4: 18.0})


def test_bench_kernel_times_a_cpu_callable():
    a = torch.arange(1 << 12, dtype=torch.int64)
    stats = bench_kernel(torch.mul, (a, a), name="mul", reps=5,
                         work=(3 * a.numel() * 8, a.numel()))
    assert 0 < stats.best_s <= stats.median_s
    assert stats.reps == 5 and stats.bytes_accessed == 3 * a.numel() * 8
    assert stats.bound_by in ("bytes", "operations")
    assert stats.bound_fraction == pytest.approx(stats.bound_ms / (stats.best_s * 1e3))
    assert re.fullmatch(
        r"mul: best \d+\.\d{3} ms \(median \d+\.\d{3} ms, compile \d+\.\d s\), "
        r"\d+\.\d% of HBM speed-of-light, \d+\.\d% of the IMAD rate, "
        r"bound \S+ ms by (bytes|operations) \(\d+\.\d% of best\)", stats.summary())
    plain = bench_kernel(torch.add, (a, a), name="add", reps=3)
    assert plain.sol_fraction is None and plain.bound_ms is None
    assert re.fullmatch(r"add: best \d+\.\d{3} ms \(median \d+\.\d{3} ms, "
                        r"compile \d+\.\d s\)", plain.summary())


def test_speed_of_light_refuses_a_card_it_does_not_know():
    assert speed_of_light("NVIDIA H100 80GB HBM3") is H100
    assert speed_of_light("cpu") is CPU
    with pytest.raises(ValueError, match="no speed-of-light entry"):
        speed_of_light("NVIDIA A100-SXM4-80GB")
    assert H100.imad_per_s == 132 * 64 * 1980e6


# PERF.md's kernel table (bound column, H100 entry at 1980 MHz) and the
# unrounded values chip_smoke.py printed for the same shapes before the move
BOUNDS = [
    ("K1", "mont_mul", {"M": 1 << 19}, 12, 0.0225, 0.02253655880597015),
    ("K2", "scan_mixed", {"C": 512, "B": 16384}, 12, 3.833, 3.8334648301193757),
    ("K2", "scan_gathered", {"C": 512, "B": 16384, "N": 1 << 19, "G": 16}, 12, 3.833,
     3.8334648301193757),
    ("K3", "ec_add", {"B": 16384}, 12, 0.00806, 0.00806317722681359),
    ("K4", "reduce_cols", {"C": 256, "B": 8192}, 12, 1.032, 1.0320866850321395),
    # K4's gathered form: the rows form's products; its bytes lie below them
    ("K4", "reduce_buckets", {"C": 256, "B": 8192, "G": 16, "buckets": 1 << 16}, 12, 1.032,
     1.0320866850321395),
    ("K5", "dbl_n", {"B": 16, "k": 16}, 12, 0.000126, 0.00012598714416896234),
    ("K6", "fold_horner", {"Wn": 16, "c": 16}, 12, 0.000125, 0.00012549500688705233),
    ("K7", "ntt_base", {"K": 512, "lanes": 1 << 18}, 8, 7.418, 7.4183111111111115),
    ("K7", "ntt_base", {"K": 128, "lanes": 1 << 20}, 8, 5.312, 5.312387878787878),
    ("K7", "ntt_base", {"K": 64, "lanes": 1 << 21}, 8, 4.270, 4.269769696969697),
    ("K8", "mul_lm", {"M": 1 << 16, "N": 1, "operands": 2}, 8, 0.00188, 0.001878046567164179),
    ("K9", "twiddle_mul", {"A": 512, "J": 512, "S": 512, "B": 1}, 8, 4.237, 4.236670707070707),
    ("K10", "poseidon_perm", {"t": 12, "B": 1 << 24, "r_f": 8, "r_p": 60, "convert_in": 1,
                              "sparse": 1}, 8, 563.5, 563.477204040404),
]


@pytest.mark.parametrize("kid,name,shape,W,table,printed", BOUNDS,
                         ids=[f"{b[0]}-{b[1]}-{i}" for i, b in enumerate(BOUNDS)])
def test_bounds_reproduce_the_perf_table(kid, name, shape, W, table, printed):
    ms, _ = work_bound_ms(name, shape, W, H100)
    # within one unit of the table's last (third or fourth) significant digit
    digits = len(re.sub(r"^0\.0*|\.", "", repr(table)))
    unit = 10 ** (math.floor(math.log10(table)) - digits + 1)
    assert abs(ms - table) < unit, (kid, ms, table)
    assert ms == pytest.approx(printed, rel=1e-12)


def test_bound_picks_the_larger_of_bytes_and_operations():
    assert work_bound_ms("mont_mul", {"M": 1 << 19}, 12, H100)[1] == "bytes"
    assert work_bound_ms("scan_mixed", {"C": 512, "B": 16384}, 12, H100)[1] == "operations"
    gathered = {"C": 512, "B": 16384, "N": 1 << 19, "G": 16}
    assert work_bound_ms("scan_gathered", gathered, 12, H100)[1] == "operations"
    # the points and the int64 order read once, the prefixes written once
    assert kernel_work("scan_gathered", gathered, 12)[0] == (
        (1 << 19) * 96 + 16 * (1 << 19) * 8 + 512 * 16384 * 144 + 16384 * 144)
    with pytest.raises(ValueError):
        kernel_work("no_such_kernel", {}, 8)


def test_fp2_kernels_count_karatsuba_products():
    """On F_p2 coordinates (BN254's G2, W = 8 a component) a point is 192 B
    and a product 656 IMADs: three unreduced 8-word products (128) and two
    REDCs (136)."""
    assert fp2_product_imads(8) == 3 * 128 + 2 * 136
    gathered = {"C": 512, "B": 16384, "N": 1 << 19, "G": 16}
    assert kernel_work("scan_gathered", gathered, 8, degree=2) == (
        (1 << 19) * 128 + 16 * (1 << 19) * 8 + 512 * 16384 * 192 + 16384 * 192,
        13 * 512 * 16384 * 656)
    assert kernel_work("ec_add", {"B": 16}, 8, degree=2) == (3 * 16 * 192, 14 * 16 * 656)
    assert kernel_work("ec_add", {"B": 16}, 8) == (3 * 16 * 96, 14 * 16 * 264)


def test_field_ew_is_bound_by_its_bytes():
    """KF moves its operands and its result, W x 4 B each per element, and
    makes no product."""
    ms, by = work_bound_ms("field_ew", {"M": 1 << 23, "operands": 2}, 12, H100)
    assert by == "bytes"
    assert ms == pytest.approx(3 * (1 << 23) * 48 / H100.hbm_bytes_per_s * 1e3, rel=1e-12)
    assert kernel_work("field_ew", {"M": 48, "operands": 1}, 12) == (2 * 48 * 48, 0)


def test_work_counts():
    bls, fr = CURVES["bls12_381"], FIELDS["bls12_381_fr"]
    nbytes, imads = msm_work(bls, 1 << 24, 16)
    assert nbytes == 128 << 24                          # 128 B per BLS12-381 point
    per = 4 * 12 * 12 + 12
    assert imads == (16 * (13 * (1 << 24) + 28 * ((1 << 16) - 1)) + 14 * 15 * 17) * per
    nbytes, imads = ntt_work(fr, 27)
    assert nbytes == 2 * (1 << 27) * 32
    assert imads == ((1 << 26) * 27 - ((1 << 27) - 1)) * (4 * 64 + 8)
    leaf, node = generate_params(fr, 12), generate_params(fr, 9)
    nbytes, _ = poseidon_work(fr, 9, leaf, node)
    assert nbytes == (1 << 24) * 12 * 32
    assert pipeline_work(bls, 27, 24, 16) == tuple(
        a + b for a, b in zip(ntt_work(fr, 27), msm_work(bls, 1 << 24, 16)))
    # 32-bit words: the JAX version counts 16-bit limbs, twice as many
    assert field_mul_traffic_bytes(1 << 10, 12) == 3 * (1 << 10) * 12 * 4
    assert jax_profile.field_mul_traffic_bytes(1 << 10, 24) == 2 * field_mul_traffic_bytes(
        1 << 10, 12)


# ------------------------------------------------------------- microbench
@pytest.mark.parametrize("field", ["bls12_381_fr", "bls12_381_fq"])
def test_microbench_spot_check(field):
    recs = microbench.run(field, 6, "cpu", reps=2)
    assert [r["kernel"] for r in recs] == ["mont_mul", "mul_lm"]
    assert all(r["spot_check"] and r["ms"] > 0 for r in recs)


# ----------------------------------------------------------------- oracles
def test_subgroup_instance_is_distinct_and_its_expectation_holds():
    spec = CURVES["bn254"]
    upoints, scal, want = subgroup_msm_instance(spec, 512, 4)
    vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in scal]
    assert len(set(vals)) == 512 and max(vals) < spec.fr.p
    assert want == class_sum_expected(spec, upoints, vals)
    oracle = ECOracle(spec)
    assert want == oracle.msm([upoints[i % 256] for i in range(512)], vals)
    with pytest.raises(ValueError):
        subgroup_msm_instance(spec, 100, 4)


@pytest.mark.parametrize("name", sorted(G1_CURVES))
def test_oracle_mul_equals_affine_double_and_add(name):
    o = ECOracle(CURVES[name])
    rng = random.Random(11)

    def slow(pt, k):
        k %= o.r
        acc, add = None, pt
        while k:
            if k & 1:
                acc = o.add(acc, add)
            add = o.dbl(add)
            k >>= 1
        return acc

    pts = [o.random_point(rng), o.random_subgroup_point(rng), o.generator]
    ks = [0, 1, 2, 3, o.r - 1, o.r, o.r + 1] + [rng.randrange(o.r) for _ in range(3)]
    for pt in pts:
        for k in ks:
            assert o.mul(pt, k) == slow(pt, k)
    assert o.mul(None, 5) is None
    assert o.mul(pts[1], o.r - 1) == o.neg(pts[1])
    assert np.all([o.on_curve(o.mul(pt, k)) for pt in pts for k in ks])
