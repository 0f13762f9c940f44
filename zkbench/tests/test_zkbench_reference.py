"""The plain reference: independent of the program (it imports none of
it), and in agreement with it and with Python ints at small sizes."""
import ast
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zkbench.reference import ec, evaluate, fields, poseidon

ROOT = Path(__file__).resolve().parents[2]
REF = ROOT / "zkbench" / "reference"
ALLOWED = {"__future__", "dataclasses", "random", "numpy", "torch"}


def test_the_reference_imports_nothing_of_the_program():
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= ALLOWED, (path.name, names)
    code = ("import sys; import zkbench.reference.ec, zkbench.reference.evaluate, "
            "zkbench.reference.fields, zkbench.reference.poseidon; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'blaze_tpu_torch', 'blaze_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("logn", [0, 1, 5, 8, 11])
def test_evaluate_equals_python_ints(logn):
    p = fields.modulus("bls12_381_fr")
    rng = random.Random(logn)
    xs = [rng.randrange(p) for _ in range(1 << logn)]
    xs[0] = p + rng.randrange(2 ** 255 - p)               # lazy values count too
    v = torch.from_numpy(fields.ints_to_words(xs, 8).view(np.int32))
    zs = [rng.randrange(p), 1, fields.root_of_unity(p, logn)]
    want = [sum(x * pow(z, i, p) for i, x in enumerate(xs)) % p for z in zs]
    assert evaluate.evaluate(v, zs, p) == want


def test_canonical_count():
    p = fields.modulus("bls12_381_fr")
    vals = [0, p - 1, p, p + 1, 2 ** 256 - 1, (p - 1) ^ (1 << 40)]
    w = torch.from_numpy(fields.ints_to_words(vals, 8).view(np.int32))
    assert fields.count_noncanonical(w, p) == sum(v >= p for v in vals)


def test_constants_agree_with_the_program():
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import generate_params

    for name in fields.MODULI:
        assert fields.modulus(name) == FIELDS[name].p
    fr = FIELDS["bls12_381_fr"]
    for logn in (1, 10, 27, 32):
        assert fields.root_of_unity(fr.p, logn) == fr.root_of_unity(logn)
    g1, spec = ec.G1("bls12_381"), CURVES["bls12_381"]
    assert (g1.p, g1.r, g1.b, g1.g) == (spec.fq.p, spec.fr.p, spec.b, (spec.gx, spec.gy))
    for t, r_p in ((12, 60), (9, 63)):
        mine, theirs = poseidon.instance(fr.p, t, 8, r_p), generate_params(fr, t)
        assert theirs.r_p == r_p
        assert (mine.rc, mine.mds) == (theirs.round_constants, theirs.mds)


def test_subgroup_points_are_on_the_curve_and_of_order_r():
    g1 = ec.G1("bls12_381")
    pts = ec.subgroup_points("bls12_381", 4, 11)
    assert len(set(pts)) == 4 and all(g1.on_curve(P) for P in pts)
    assert all(g1.mul(P, g1.r) is None for P in pts)
    assert pts == ec.subgroup_points("bls12_381", 4, 11)


def test_tiled_msm_equals_the_direct_sum():
    g1 = ec.G1("bls12_381")
    rng = random.Random(5)
    pts = ec.subgroup_points("bls12_381", 3, 5, multiplier_bits=16)
    scalars = [rng.randrange(g1.r) for _ in range(9)]
    direct = g1.msm([pts[i % 3] for i in range(9)], scalars)
    sums = [sum(scalars[u::3]) % g1.r for u in range(3)]
    assert ec.tiled_msm("bls12_381", pts, sums) == direct


def test_the_program_agrees_with_the_reference_on_a_tiny_msm():
    from blaze_tpu_torch.curves import CURVES, Curve
    from blaze_tpu_torch.msm import MSM, points_to_resident

    g1, cv = ec.G1("bls12_381"), Curve(CURVES["bls12_381"])
    pts = ec.subgroup_points("bls12_381", 4, 3)
    rng = random.Random(3)
    scalars = [rng.randrange(g1.r) for _ in range(16)]
    xy = fields.ints_to_words([c for P in pts for c in P], 12).view(np.int32)
    res = points_to_resident(cv, torch.from_numpy(xy.reshape(4, 2, 12))).repeat(1, 4)
    sc = torch.from_numpy(fields.ints_to_limbs16(scalars, 16).astype(np.int32)).t()
    X, Y, Z = fields.words_to_ints(MSM(cv)(res, sc.contiguous()).numpy())
    zi = pow(Z, -1, g1.p)
    assert (X * zi % g1.p, Y * zi % g1.p) == g1.msm([pts[i % 4] for i in range(16)], scalars)


def test_the_program_agrees_with_the_reference_on_a_tiny_tree():
    from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters

    p = fields.modulus("bls12_381_fr")
    rng = random.Random(9)
    cols = [[rng.randrange(p) for _ in range(11)] for _ in range(8)]
    cl = PoseidonClient("bls12_381_fr", device="cpu")
    cl.initialize(PoseidonInitializeParameters(tree_height=2))
    cl.set_data(fields.ints_to_words([v for c in cols for v in c], 8).tobytes())
    cl.start_process()
    cl.wait_result()
    leaf, node = poseidon.instance(p, 12, 8, 60), poseidon.instance(p, 9, 8, 63)
    leaves = [poseidon.hash_(leaf, c) for c in cols]
    assert fields.words_to_ints(cl.root[None]) == [poseidon.hash_(node, leaves)]
