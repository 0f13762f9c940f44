"""The G2 cell's plain reference and its job loop on the CPU: BN254's G2 law
in Python ints (zkbench/reference/bn254_g2.py) on sampled points, the
cell's frozen work counts, and the loop (loops/msm_g2.py) at a small size,
sound and with the control and each fault planted under the timed path."""
import random
import time

import pytest

from zkbench import harness, work
from zkbench.reference import bn254_g2 as g2

CELL = "groth16_bn254_g2.msm_g2_resident"


def test_the_reference_group_law():
    """P2 on the twist and of order r; the identity, inverses and
    associativity on sampled points; the MSM against the sum of multiples
    and the tiled MSM against the MSM of the tiles."""
    assert g2.on_curve(g2.G) and not g2.on_curve((g2.G[0], g2.add(g2.G[1], g2.ONE)))
    assert g2.point_mul(g2.G, g2.R, reduce=False) is None
    assert g2.point_mul(g2.G, g2.R + 5, reduce=False) == g2.point_mul(g2.G, 5)
    pts = g2.subgroup_points(6, 17)
    assert all(g2.on_curve(p) for p in pts) and len(set(pts)) == 6
    a, b, c = pts[:3]
    assert g2.point_add(g2.point_add(a, b), c) == g2.point_add(a, g2.point_add(b, c))
    assert g2.point_add(a, b) == g2.point_add(b, a)
    assert g2.point_add(a, None) == a and g2.point_add(None, a) == a
    assert g2.point_add(a, g2.neg(a)) is None
    assert g2.point_add(a, a) == g2.point_mul(a, 2)
    rng = random.Random(3)
    ks = [rng.randrange(g2.R) for _ in range(6)]
    want = None
    for p, k in zip(pts, ks):
        want = g2.point_add(want, g2.point_mul(p, k))
    assert g2.msm(pts, ks) == want
    tiled = pts[:2] * 3
    sc = [rng.randrange(g2.R) for _ in tiled]
    assert g2.tiled_msm(pts[:2], [(sc[0] + sc[2] + sc[4]) % g2.R,
                                  (sc[1] + sc[3] + sc[5]) % g2.R]) == g2.msm(tiled, sc)
    assert g2.mul(g2.inv((5, 7)), (5, 7)) == g2.ONE and g2.mul((0, 1), (0, 1)) == (g2.P - 1, 0)


def test_the_cells_work_counts():
    """The least work of one 2^24-base G2 MSM at c = 16 in F_p2 products
    (Karatsuba with lazy reduction: three unreduced 8-word products of 128
    IMADs and two REDCs of 136, 656 IMADs): the whole MSM, K2's mixed adds
    and the bucket reduction."""
    cell = harness.resolve(CELL)
    job = cell.loop.Loop(cell.config, cell.traffic, 5, "cpu")
    n = 1 << 24
    fp2 = 16 * (13 * n + 14 * 2 * 65535) + 14 * 15 * 17
    assert fp2 == 3_519_024_178
    assert job.work() == (n * (128 + 32), fp2 * 656)
    assert job.scan_work() == (n * 128, 16 * 13 * n * 656)
    assert job.bucket_work() == (16 * 65536 * 192, 16 * 14 * 2 * 65535 * 656)
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert work.bound_s(job.work(), peaks) == (pytest.approx(0.13800, rel=1e-3), "operations")


@pytest.mark.parametrize("plant", ["sound", "control", "unchanged", "half", "altered"])
def test_the_loop_catches_the_control_and_every_fault(small_cell, plant):
    """At 2^6 bases over 4 distinct points: sound, correct with 0 wrong;
    with the control (X's first component left lazy) or a fault planted,
    not correct."""
    cell = small_cell(CELL)
    cell.config.update(msm_log_points=6, msm_unique_points=4)
    fault = {"sound": None, "control": cell.loop.control}.get(plant, cell.loop.FAULTS.get(plant))
    res, lines = harness.run(cell, 3_100_000_000 + len(plant), 0.01, False, "cpu",
                             time.perf_counter(), fault=fault)
    assert res["attempted"] >= 2
    wrong = res["checks"]["msm_results_wrong"]["value"]
    if plant == "sound":
        assert res["correct"] and res["failed"] == 0 and wrong == 0, lines
    else:
        assert not res["correct"] and res["failed"] >= 1 and wrong > 0, lines
