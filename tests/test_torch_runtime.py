"""The port's MSMClient lifecycle on the CPU (device="cpu"), against the
oracle and blaze_tpu's client, and the port's import and device rules.

Covers the three set_data modes, the streaming order (start_process before
set_data), the task FIFO, precomputed multiples and the error paths, and the
four repairs over blaze_tpu's client (a streamed chunk split by chunk_log2,
the precompute layout of load_data_to_hbm, the lock, params on a streamed
chunk); DeviceContext's profile, live_buffers and load_binary on the CPU;
checks
that blaze_tpu_torch and chip_smoke.py import neither jax nor blaze_tpu, and
that the entry points default to CUDA and raise without it.
"""
import ast
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from blaze_tpu.runtime import MSMClient as RefMSMClient, MSMInit as RefMSMInit
from blaze_tpu.runtime import MSMInput as RefMSMInput, MSMParams as RefMSMParams
from blaze_tpu.runtime import NTTClient as RefNTTClient, NTTInit as RefNTTInit
from blaze_tpu.runtime import NTTInput as RefNTTInput
from blaze_tpu_torch.curves import (
    CURVES,
    decode_projective_result,
    encode_affine_points,
    encode_scalars,
)
from blaze_tpu_torch.fields import FIELDS, int_to_words, words_to_int
from blaze_tpu_torch.msm import MSMConfig
from blaze_tpu_torch.oracle import ECOracle, random_msm_instance
from blaze_tpu_torch.oracle.gen import points_to_affine_words
from blaze_tpu_torch.runtime import (
    DeviceContext,
    MSMClient,
    MSMInit,
    MSMInput,
    MSMParams,
    NTTClient,
    NTTInit,
    NTTInput,
)
from blaze_tpu_torch.runtime.device import TRACE_FILE
from blaze_tpu_torch.utils import (
    DataError,
    DeviceError,
    InvalidPrimitiveParam,
    LoadFailed,
    NotReady,
)

# One intra-op thread: the plain versions run many tiny ops, on which
# torch's OpenMP workers only spin, and the suite runs several
# processes at once.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 32
CURVE = "bn254"


def wire_input(seed=50, n=N):
    spec = CURVES[CURVE]
    points, scalars, expected, _ = random_msm_instance(spec, n, seed)
    return encode_affine_points(points, spec), encode_scalars(scalars, spec), expected


def affine(raw: bytes):
    """z||y||x result bytes -> affine ints (the oracle's normalisation)."""
    spec = CURVES[CURVE]
    X, Y, Z = (words_to_int(v) for v in decode_projective_result(raw, spec))
    p = spec.fq.p
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


def cpu_client(**kw):
    return MSMClient(MSMInit(curve=CURVE, **kw), device="cpu")


def test_dma_mode_matches_oracle_and_reference_client():
    praw, sraw, expected = wire_input()
    client = cpu_client(mem_type="dma")
    img = client.loaded_binary_parameters()
    assert img.fields["point_bytes"] == 64 and img.fields["result_bytes"] == 96
    client.initialize(MSMParams(nof_elements=N))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    client.start_process()
    client.wait_result()
    res = client.result()
    assert len(res.result) == 96 and res.label == 0
    assert affine(res.result) == expected

    ref = RefMSMClient(RefMSMInit(curve="BN254", mem_type="dma"))
    ref.initialize(RefMSMParams(nof_elements=N))
    ref.set_data(RefMSMInput(scalars=sraw, points=praw))
    ref.start_process()
    assert affine(ref.result().result) == affine(res.result)


def test_hbm_point_cache_and_scalar_only_reuse():
    spec = CURVES[CURVE]
    points, scalars, expected, dbg = random_msm_instance(spec, N, 50)
    praw, sraw = encode_affine_points(points, spec), encode_scalars(scalars, spec)
    sraw2 = encode_scalars(scalars[::-1], spec)   # new scalars, same points
    expected2 = ECOracle(spec).msm(dbg["points"], dbg["scalars"][::-1])
    client = cpu_client(mem_type="hbm")
    params = MSMParams(nof_elements=N, hbm_point_addr="bank0")
    client.initialize(params)
    client.set_data(MSMInput(scalars=sraw, points=praw))          # mode 2
    client.start_process()
    assert affine(client.result().result) == expected
    client.set_data(MSMInput(scalars=sraw2))                      # mode 3
    client.start_process()
    assert affine(client.result().result) == expected2
    assert encode_affine_points(client.get_data_from_hbm("bank0"), spec) == praw


def test_get_data_from_hbm_returns_the_reference_limbs():
    """Both packages cache the same points (set_data under a key, and
    load_data_to_hbm) and read them back in the reference's form: (N, 2, L)
    uint32 canonical 16-bit limbs, equal in dtype, shape and value."""
    spec = CURVES[CURVE]
    points, scalars, _, _ = random_msm_instance(spec, N, 51)
    praw, sraw = encode_affine_points(points, spec), encode_scalars(scalars, spec)
    client = cpu_client(mem_type="hbm")
    client.initialize(MSMParams(nof_elements=N, hbm_point_addr="bank0"))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    client.load_data_to_hbm("bank1", praw)
    ref = RefMSMClient(RefMSMInit(curve="BN254", mem_type="hbm"))
    ref.initialize(RefMSMParams(nof_elements=N, hbm_point_addr="bank0"))
    ref.set_data(RefMSMInput(scalars=sraw, points=praw))
    ref.load_data_to_hbm("bank1", praw)
    for key in ("bank0", "bank1"):
        got, want = client.get_data_from_hbm(key), np.asarray(ref.get_data_from_hbm(key))
        assert got.dtype == want.dtype == np.uint32
        assert got.shape == want.shape == (N, 2, spec.fq.nlimbs)
        assert np.array_equal(got, want), key
        assert encode_affine_points(got, spec) == praw


def test_streaming_order_and_task_fifo():
    """initialize -> start_process -> set_data chunks -> result, including
    a streamed scalars-only pass over cached points, then two queued tasks
    popped in label order."""
    praw, sraw, expected = wire_input()
    spec = CURVES[CURVE]
    pb, sb, half = spec.point_bytes, spec.scalar_bytes, N // 2
    client = cpu_client()
    client.initialize(MSMParams(nof_elements=N))
    client.start_process()
    assert client.get_api()["streamed_elements"] == 0
    client.set_data(MSMInput(scalars=sraw[: half * sb], points=praw[: half * pb]))
    with pytest.raises(NotReady):
        client.wait_result()                   # half the elements fed
    client.set_data(MSMInput(scalars=sraw[half * sb:], points=praw[half * pb:]))
    assert affine(client.result().result) == expected

    client.load_data_to_hbm("k", praw)
    client.initialize(MSMParams(nof_elements=N, hbm_point_addr="k"))
    client.start_process()
    for lo in (0, half):
        client.set_data(MSMInput(scalars=sraw[lo * sb:(lo + half) * sb]))
    assert affine(client.result().result) == expected

    client.set_data(MSMInput(scalars=sraw, points=praw))
    client.start_process()
    client.start_process()
    assert client.pending_tasks == 2 and not client.is_msm_engine_ready()
    labels = [client.result().label, client.result().label]
    assert labels == [2, 3] and client.result() is None


def test_precompute_factor_8_matches_oracle():
    spec = CURVES[CURVE]
    oracle = ECOracle(spec)
    points, scalars, expected, dbg = random_msm_instance(spec, 4, seed=9)
    shift = 32
    expanded = []
    for x, y in dbg["points"]:                 # point-major wire order
        pt = (x, y)
        for _ in range(8):
            expanded.append(pt)
            pt = oracle.mul(pt, 1 << shift)
    client = cpu_client(precompute_factor=8)
    client.initialize(MSMParams(nof_elements=4))
    client.set_data(MSMInput(scalars=encode_scalars(scalars, spec),
                             points=encode_affine_points(
                                 points_to_affine_words(spec, expanded), spec)))
    client.start_process()
    assert affine(client.result().result) == expected


def test_error_paths():
    praw, sraw, _ = wire_input()
    spec = CURVES[CURVE]
    client = cpu_client()
    with pytest.raises(NotReady):
        client.start_process()                 # no params, no data
    with pytest.raises(NotReady):
        client.set_data(MSMInput(scalars=sraw))  # no MSMParams yet
    client.initialize(MSMParams(nof_elements=N))
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(MSMInput(scalars=sraw, points=praw[: -spec.point_bytes]))
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(MSMInput(scalars=sraw[: -spec.scalar_bytes], points=praw))
    with pytest.raises(NotReady):
        client.set_data(MSMInput(scalars=sraw))  # scalars-only, nothing cached
    client.start_process()                     # opens a stream
    with pytest.raises(NotReady):
        client.start_process()                 # stream already open
    client.set_data(MSMInput(scalars=sraw, points=praw))
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(MSMInput(scalars=sraw[: spec.scalar_bytes],
                                 points=praw[: spec.point_bytes]))  # overflow
    assert client.result() is not None


def limbs_of(words: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> the reference's (..., 2W) uint32 16-bit limbs."""
    return np.ascontiguousarray(words, dtype="<u4").view("<u2").astype(np.uint32)


def test_msm_client_takes_the_reference_array_form():
    """MSMInput.points as blaze_tpu takes them, (N, 2, L) 16-bit limbs: the
    same result bytes as the wire form, and the same point as blaze_tpu's
    client on the same arrays (its CPU path is another algorithm, so its
    projective representative differs: compared affine).  Any other
    shape, or a limb of 16 bits, raises DataError."""
    spec = CURVES[CURVE]
    points, scalars, expected, _ = random_msm_instance(spec, N, 50)
    limbs = limbs_of(points)
    assert limbs.shape == (N, 2, spec.fq.nlimbs)

    def run(scal, pts):
        client = cpu_client()
        client.initialize(MSMParams(nof_elements=N))
        client.set_data(MSMInput(scalars=scal, points=pts))
        client.start_process()
        return client.result().result

    got = run(scalars, limbs)
    assert got == run(encode_scalars(scalars, spec), encode_affine_points(points, spec))
    assert affine(got) == expected
    ref = RefMSMClient(RefMSMInit(curve="BN254", mem_type="dma"))
    ref.initialize(RefMSMParams(nof_elements=N))
    ref.set_data(RefMSMInput(scalars=scalars, points=limbs))
    ref.start_process()
    assert affine(ref.result().result) == affine(got)

    client = cpu_client()
    client.initialize(MSMParams(nof_elements=N))
    over = limbs.copy()
    over[3, 1, 5] = 1 << 16
    for scal, pts in ((scalars, limbs[:, :, :5]), (scalars, limbs.reshape(N, -1)),
                      (scalars, limbs[None]), (scalars, over), (scalars[:, :3], limbs)):
        with pytest.raises(DataError):
            client.set_data(MSMInput(scalars=scal, points=pts))


def test_ntt_client_takes_the_reference_array_form():
    """NTTInput.data as blaze_tpu takes it, (n, L) 16-bit limbs: the same
    result bytes as blaze_tpu's client and as the port's wire form; any
    other shape, or a limb of 16 bits, raises DataError."""
    field, logn = "bn254_fr", 6
    spec = FIELDS[field]
    rng = np.random.default_rng(60)
    vals = [int(v) % spec.p for v in rng.integers(0, 1 << 62, size=1 << logn)]
    words = np.stack([int_to_words(v * (1 << 190) % spec.p, spec.nwords) for v in vals])
    limbs = limbs_of(words)

    def run(data):
        client = NTTClient(NTTInit(field=field, logn=logn), device="cpu")
        client.set_data(NTTInput(data=data))
        client.start_process()
        client.wait_result()
        return client.result()

    got = run(limbs)
    assert got == run(words.tobytes())
    ref = RefNTTClient(RefNTTInit(field=field, logn=logn))
    ref.set_data(RefNTTInput(data=limbs))
    ref.start_process()
    ref.wait_result()
    assert got == ref.result()

    client = NTTClient(NTTInit(field=field, logn=logn), device="cpu")
    over = limbs.copy()
    over[7, 2] = 1 << 16
    for bad in (limbs[:, :5], limbs[:, :, None], limbs.reshape(-1), over):
        with pytest.raises(DataError):
            client.set_data(NTTInput(data=bad))


def test_streamed_chunk_is_split_by_chunk_log2():
    """A streamed chunk larger than 2^chunk_log2 points runs as one partial
    per 2^chunk_log2 slice, as MSM.__call__ slices a large input: the bytes
    equal those of the same points fed slice by slice and of the staged
    (non-streamed) client."""
    praw, sraw, expected = wire_input()
    spec = CURVES[CURVE]
    pb, sb, step = spec.point_bytes, spec.scalar_bytes, 8
    results = []
    for chunks in (N, step):
        client = MSMClient(MSMInit(curve=CURVE), config=MSMConfig(chunk_log2=3), device="cpu")
        calls = []
        partial = client.engine.msm_partial
        client.engine.msm_partial = lambda *a, **k: calls.append(a[0].shape[1]) or partial(*a, **k)
        client.initialize(MSMParams(nof_elements=N))
        client.start_process()
        for lo in range(0, N, chunks):
            client.set_data(MSMInput(scalars=sraw[lo * sb:(lo + chunks) * sb],
                                     points=praw[lo * pb:(lo + chunks) * pb]))
        results.append(client.result().result)
        assert calls == [step] * (N // step)
    staged = MSMClient(MSMInit(curve=CURVE), config=MSMConfig(chunk_log2=3), device="cpu")
    staged.initialize(MSMParams(nof_elements=N))
    staged.set_data(MSMInput(scalars=sraw, points=praw))
    staged.start_process()
    assert results[0] == results[1] == staged.result().result
    assert affine(results[0]) == expected


def test_precompute_cache_from_load_data_to_hbm_matches_oracle():
    """load_data_to_hbm takes wire order (each base, then its multiples) and
    stores the engine's multiple-major layout: a scalars-only task over that
    cache, staged or streamed, gives the oracle MSM.  A cache that does not
    hold factor * nof_elements points is refused."""
    spec = CURVES[CURVE]
    oracle = ECOracle(spec)
    points, scalars, expected, dbg = random_msm_instance(spec, 4, seed=11)
    expanded = []
    for x, y in dbg["points"]:                 # point-major wire order
        pt = (x, y)
        for _ in range(8):
            expanded.append(pt)
            pt = oracle.mul(pt, 1 << 32)
    praw = encode_affine_points(points_to_affine_words(spec, expanded), spec)
    sraw = encode_scalars(scalars, spec)
    for streamed in (False, True):
        client = cpu_client(precompute_factor=8)
        client.load_data_to_hbm("bank", praw)
        client.initialize(MSMParams(nof_elements=4, hbm_point_addr="bank"))
        if streamed:                                                # streamed mode 3
            client.start_process()
            for lo in (0, 2):
                client.set_data(MSMInput(
                    scalars=sraw[lo * spec.scalar_bytes:(lo + 2) * spec.scalar_bytes]))
        else:                                                       # staged mode 3
            client.set_data(MSMInput(scalars=sraw))
            client.start_process()
        assert affine(client.result().result) == expected
    client.load_data_to_hbm("short", praw[: 8 * spec.point_bytes])  # one base only
    client.initialize(MSMParams(nof_elements=4, hbm_point_addr="short"))
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(MSMInput(scalars=sraw))
    with pytest.raises(InvalidPrimitiveParam):
        client.load_data_to_hbm("ragged", praw[: 7 * spec.point_bytes])


def test_concurrent_set_data_and_result_give_the_oracle_result():
    """Two feeder threads stream chunks into one open task while a third
    polls result(): the lock keeps every partial (no lost update).  A slow
    accumulation (as on a busy device) widens the read-modify-write window,
    and a barrier starts both feeders together."""
    praw, sraw, expected = wire_input()
    spec = CURVES[CURVE]
    pb, sb, step = spec.point_bytes, spec.scalar_bytes, 4
    client = cpu_client()
    client.initialize(MSMParams(nof_elements=N))
    client.start_process()
    accumulate = client.engine.accumulate

    def slow_accumulate(wsums, part):
        time.sleep(0.05)
        return accumulate(wsums, part)

    client.engine.accumulate = slow_accumulate
    got = []
    start = threading.Barrier(2)

    def feed(starts):
        start.wait(timeout=60)
        for lo in starts:
            client.set_data(MSMInput(scalars=sraw[lo * sb:(lo + step) * sb],
                                     points=praw[lo * pb:(lo + step) * pb]))

    def poll():
        deadline = time.monotonic() + 120
        while not got and time.monotonic() < deadline:
            try:
                res = client.result()
            except NotReady:
                time.sleep(0.001)
                continue
            if res is not None:
                got.append(res)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=feed, args=(range(0, N, 2 * step),)),
                   threading.Thread(target=feed, args=(range(step, N, 2 * step),)),
                   threading.Thread(target=poll)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert len(got) == 1 and affine(got[0].result) == expected


def test_params_on_a_streamed_chunk_raise():
    praw, sraw, _ = wire_input()
    client = cpu_client()
    client.initialize(MSMParams(nof_elements=N))
    client.start_process()
    with pytest.raises(InvalidPrimitiveParam):
        client.set_data(MSMInput(scalars=sraw, points=praw, params=MSMParams(nof_elements=N)))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    assert client.result() is not None


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(DeviceError):
        MSMClient(MSMInit())
    with pytest.raises(DeviceError):
        DeviceContext()
    ctx = DeviceContext(device="cpu")
    assert ctx.device.type == "cpu" and ctx.health().ok()


def test_profile_writes_a_trace_of_a_cpu_block(tmp_path):
    """DeviceContext.profile: torch.profiler around the block, its
    Chrome/Perfetto trace written to trace_dir (made if missing), the
    profiler yielded for key_averages()."""
    ctx = DeviceContext(device="cpu")
    trace_dir = tmp_path / "trace"
    with ctx.profile(trace_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((trace_dir / TRACE_FILE).read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_load_binary_times_the_warm_ups_and_raises_load_failed():
    """DeviceContext.load_binary: every warm-up is called once, the wall
    seconds come back as a float; a failing warm-up raises LoadFailed
    naming it, with the error as its cause.  (On the CPU nothing is built:
    the plain versions need no library.)"""
    ctx = DeviceContext(device="cpu")
    calls = []
    secs = ctx.load_binary([lambda: calls.append(1), lambda: calls.append(2)])
    assert isinstance(secs, float) and secs >= 0 and calls == [1, 2]

    def warm_up_that_fails():
        raise RuntimeError("no kernel")

    with pytest.raises(LoadFailed, match="warm_up_that_fails") as info:
        ctx.load_binary([warm_up_that_fails])
    assert isinstance(info.value.__cause__, RuntimeError)


def test_live_buffers_is_minus_one_on_the_cpu():
    """The caching allocator's active-block count exists only on a card;
    the CPU context answers -1, as the JAX version does when it cannot
    count."""
    assert DeviceContext(device="cpu").live_buffers() == -1


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "blaze_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "blaze_tpu")]
    assert bad == []


def test_cpu_msm_loads_no_jax():
    code = (
        "import sys\n"
        "from blaze_tpu_torch.runtime import MSMClient, MSMInit, MSMInput, MSMParams\n"
        "from blaze_tpu_torch.curves import CURVES, encode_affine_points, encode_scalars\n"
        "from blaze_tpu_torch.oracle import random_msm_instance\n"
        "spec = CURVES['bn254']\n"
        "p, s, _, _ = random_msm_instance(spec, 8, 1)\n"
        "c = MSMClient(MSMInit(curve='bn254'), device='cpu')\n"
        "c.initialize(MSMParams(nof_elements=8))\n"
        "c.set_data(MSMInput(scalars=encode_scalars(s, spec), points=encode_affine_points(p, spec)))\n"
        "c.start_process()\n"
        "assert len(c.result().result) == 96\n"
        "assert 'jax' not in sys.modules and 'blaze_tpu' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
