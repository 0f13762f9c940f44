"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

    python -m pytest -m cuda tests/test_torch_cuda.py

K1-K6 against their plain PyTorch versions on the same device inputs,
exact, on all three curves, and K7-K9 on the three scalar fields; the MSM
client on the card against the oracle with distinct scalars; the NTT client
on the card against every committed golden pair, and at 2^16 (the K8
twiddle fallback) against a host NTT in Python ints with an inverse
roundtrip.  chip_smoke.py runs the same checks at the main path's sizes.
"""
import random
from pathlib import Path

import numpy as np

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
from blaze_tpu_torch import _build
from blaze_tpu_torch.fields import FIELDS, words_to_int
from blaze_tpu_torch.fields.montmul import mont_mul, mont_mul_plain
from blaze_tpu_torch.oracle import ECOracle, class_sum_expected
from blaze_tpu_torch.oracle.gen import points_to_affine_words, scalars_to_limbs
from blaze_tpu_torch.ntt import NTTKernels
from blaze_tpu_torch.runtime import (
    MSMClient,
    MSMInit,
    MSMInput,
    MSMParams,
    NTTClient,
    NTTInit,
    NTTInput,
)

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


def canonical(spec, shape, seed, dev):
    """int32 words, word axis 1, of random values below 2^(bits-1) < p."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)
    w[:, -1] &= (1 << (spec.bits - 1 - 32 * (spec.nwords - 1))) - 1
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("field", ["bn254_fr", "bls12_377_fr", "bls12_381_fr"])
def test_ntt_kernels_match_plain_versions(dev, field):
    spec = FIELDS[field]
    k, W = NTTKernels.for_spec(spec), spec.nwords
    for K, B in ((2, 100), (512, 37)):
        x, pack = canonical(spec, (K, W, B), K, dev), canonical(spec, (K, W), K + 1, dev)
        want = k.ntt_base_plain(x, pack)
        assert torch.equal(k.ntt_base(x, pack), want)
        assert torch.equal(k.ntt_base(x, pack, out=x), want)         # in place
    a, b, c = (canonical(spec, (4, W, 300), 10 + i, dev) for i in range(3))
    assert torch.equal(k.mul_lm(a, b), k.mul_lm_plain(a, b))
    assert torch.equal(k.mul_lm(a, b, c), k.mul_lm_plain(a, b, c))
    for A, J, S, B in ((8, 4, 32, 1), (8, 4, 8, 24)):
        y = canonical(spec, (A, W, J * S * B), 20, dev)
        t1, t2 = canonical(spec, (A, W, J), 21, dev), canonical(spec, (A, W, S), 22, dev)
        assert torch.equal(k.twiddle_mul(y, t1, t2, B), k.twiddle_mul_plain(y, t1, t2, B))


def _host_ntt(vals, w, p):
    """Recursive Cooley-Tukey on Python ints (scripts/gen_ntt_vectors.py)."""
    n = len(vals)
    if n == 1:
        return vals[:]
    even, odd = _host_ntt(vals[0::2], w * w % p, p), _host_ntt(vals[1::2], w * w % p, p)
    out, wk = [0] * n, 1
    for i in range(n // 2):
        t = wk * odd[i] % p
        out[i], out[i + n // 2] = (even[i] + t) % p, (even[i] - t) % p
        wk = wk * w % p
    return out


def _run(client, data):
    client.set_data(NTTInput(data=data))
    client.start_process()
    client.wait_result()
    return client.result()


def test_ntt_client_on_card_matches_goldens_and_host_ntt(dev):
    fixtures = sorted((Path(__file__).parent / "fixtures").glob("ntt_*_2e*.in"))
    assert fixtures
    for inf in fixtures:
        field, logn = inf.stem[4:].rsplit("_2e", 1)
        init = NTTInit(field=field, logn=int(logn))
        raw, want = inf.read_bytes(), inf.with_suffix(".out").read_bytes()
        assert _run(NTTClient(init), raw) == want
        assert _run(NTTClient(init, inverse=True), want) == raw

    spec, logn = FIELDS["bls12_381_fr"], 16
    rng = random.Random(4)
    vals = [rng.randrange(spec.p) for _ in range(1 << logn)]
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    _build.reset_launches()
    client = NTTClient(NTTInit(field=spec.name, logn=logn))
    assert client.ctx.device.type == "cuda"
    out = _run(client, raw)
    assert _build.LAUNCHES["ntt_base"] == 2 and _build.LAUNCHES["mul_lm"] == 1
    want = _host_ntt(vals, spec.root_of_unity(logn), spec.p)
    assert out == b"".join(v.to_bytes(32, "little") for v in want)
    assert _run(NTTClient(NTTInit(field=spec.name, logn=logn), inverse=True), out) == raw
