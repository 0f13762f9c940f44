"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

K1-K6 against their plain PyTorch versions on the same device inputs,
exact, on all three curves; and the MSM client on the card against the
oracle with distinct scalars.  chip_smoke.py runs the same checks at the
main path's sizes.
"""
import random

import pytest
import torch

from blaze_tpu_torch.curves import (
    CURVES,
    Curve,
    decode_projective_result,
    encode_affine_points,
    encode_scalars,
)
from blaze_tpu_torch.curves.kernels import ECKernels
from blaze_tpu_torch.fields import words_to_int
from blaze_tpu_torch.fields.montmul import mont_mul, mont_mul_plain
from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs
from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CURVES))
def test_kernels_match_plain_versions(dev, name):
    spec = CURVES[name]
    cv, k = Curve(spec), ECKernels.for_curve(spec)
    oracle = ECOracle(spec)
    rng = random.Random(1)
    pts = [oracle.random_point(rng) for _ in range(4 * 256)]
    aff = torch.stack([cv.fq.from_int([x for x, _ in pts], device=dev),
                       cv.fq.from_int([y for _, y in pts], device=dev)], dim=1)
    rows = aff.reshape(4, 256, -1).permute(0, 2, 1).contiguous()
    sgn = torch.randint(0, 2, (4, 1, 256), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    rows_s = torch.cat([rows, sgn], dim=1).contiguous()
    a = aff.reshape(-1, spec.fq.nwords).contiguous()
    b = a.flip(0).contiguous()
    assert torch.equal(mont_mul(spec.fq, a, b), mont_mul_plain(spec.fq, a, b))
    for r in (rows, rows_s):
        got, want = k.scan_mixed(r), k.scan_mixed_plain(r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    em = got[0]
    p, q = em[1].contiguous(), em[3].contiguous()
    assert torch.equal(k.add(p, q), k.add_plain(p, q))
    assert torch.equal(k.reduce_cols(em), k.reduce_cols_plain(em))
    assert torch.equal(k.dbl_n(p, 5), k.dbl_n_plain(p, 5))
    ws = p[:, :6].contiguous()
    assert torch.equal(k.fold_horner(ws, 5), k.fold_horner_plain(ws, 5))


def test_client_on_card_matches_oracle(dev):
    spec = CURVES["bls12_381"]
    oracle = ECOracle(spec)
    rng = random.Random(3)
    upoints = [oracle.random_subgroup_point(rng) for _ in range(16)]
    n = 4096
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    praw = encode_affine_points(points_to_affine_words(spec, upoints * (n // 16)), spec)
    client = MSMClient(MSMInit(curve="bls12_381"))
    assert client.ctx.device.type == "cuda"
    client.initialize(MSMParams(nof_elements=n))
    client.set_data(MSMInput(scalars=encode_scalars(scalars_to_limbs(spec, scalars), spec),
                             points=praw))
    client.start_process()
    X, Y, Z = (words_to_int(v)
               for v in decode_projective_result(client.result().result, spec))
    p = spec.fq.p
    zi = pow(Z, -1, p)
    assert (X * zi % p, Y * zi % p) == class_sum_expected(spec, upoints, scalars)
