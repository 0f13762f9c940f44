"""The port's tracing (blaze_tpu_torch/trace.py) on the CPU.

The trace checks (launch keys, lost launches); span as a shared no-op with
no profiler running and a mark on a CPU tensor as nothing; under a CPU
torch.profiler the spans of an MSM (call around its chunks), of the
precompute mode (the expansion; the multiples inside a call), of a height-3
PoseidonClient lifecycle (one task label on its phases and root, one level
span per node level, PhaseTimings still accumulating) and of a FusedNTT
(its levels and twiddles).

The profiler takes ~0.2 ms per recorded operation to stop and read, and a
plain kernel is thousands of small torch operations, so under it the
kernels are stand-ins of the right shapes: the spans sit around the
kernels, whose arithmetic the other test files hold.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blaze_tpu_torch import _build, trace
from blaze_tpu_torch.curves import CURVES, Curve
from blaze_tpu_torch.fields import FIELDS
from blaze_tpu_torch.hash import PoseidonKernels
from blaze_tpu_torch.msm import MSM, MSMConfig, precompute_resident
from blaze_tpu_torch.ntt import FusedNTT
from blaze_tpu_torch.oracle import tiled_msm_instance
from blaze_tpu_torch.runtime import PoseidonClient, PoseidonInitializeParameters
from blaze_tpu_torch.trace import TraceLost, check_trace, launch_key, traced_launches

torch.set_num_threads(1)


def spans(prof) -> list:
    """(name, start us, end us) of the blaze.* spans of a profile, in start
    order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("blaze.")), key=lambda s: s[1])


def named(found: list, name: str) -> list:
    return [s for s in found if s[0].split("#")[0] == name]


def test_check_trace_raises_when_events_are_lost():
    assert launch_key("void mont_mul_kernel<12>(unsigned int const*)") == "mont_mul"
    assert launch_key("void (anonymous namespace)::mul_lm_rows_kernel<8>()") == "mul_lm"
    assert launch_key("ncclDevKernel_AllGather_RING_LL") is None
    # K2's and K4's gathered forms count apart from their rows forms
    assert launch_key("void (anonymous namespace)::reduce_cols_kernel<12, (anonymous "
                      "namespace)::reduce_buckets_fetch>(...)") == "reduce_buckets"
    assert launch_key("void (anonymous namespace)::reduce_cols_kernel<12, (anonymous "
                      "namespace)::reduce_rows_fetch>(...)") == "reduce_cols"
    assert launch_key("void (anonymous namespace)::reduce_cols_kernel<12>(...)") == \
        "reduce_cols"
    assert launch_key("void (anonymous namespace)::scan_mixed_kernel<8, false, (anonymous "
                      "namespace)::scan_gathered_fetch>(...)") == "scan_gathered"
    # the NTT kernels' W = 12 builds count apart; K1 and K10 do not
    assert launch_key("void (anonymous namespace)::ntt_base_kernel<12, 9>(...)") == \
        "ntt_base_w12"
    assert launch_key("void (anonymous namespace)::mul_lm_rows_kernel<12>()") == "mul_lm_w12"
    assert launch_key("void (anonymous namespace)::poseidon_perm_kernel<12>()") == \
        "poseidon_perm"
    assert traced_launches([("void ntt_base_kernel<12, 9>(...)", 3),
                            ("void twiddle_mul_kernel<12>(...)", 2)]) == {
        "ntt_base_w12": 3, "twiddle_mul_w12": 2}
    assert traced_launches([("void ntt_base_kernel<8, 9>(...)", 2), ("Memcpy DtoD", 4),
                            ("void ntt_base_kernel<8, 7>(...)", 1),
                            ("void twiddle_mul_kernel<8>(...)", 2)]) == {"ntt_base": 3,
                                                                        "twiddle_mul": 2}
    check_trace({"ntt_base": 3, "twiddle_mul": 2}, {"ntt_base": 3, "twiddle_mul": 2}, "ok")
    check_trace({}, {"ntt_base": 0}, "nothing launched")
    with pytest.raises(TraceLost, match="ntt_base"):
        check_trace({"twiddle_mul": 2}, {"ntt_base": 3, "twiddle_mul": 2}, "lost")


def test_marks_are_program_kernels_by_name():
    """Each mark's kernel counts under its own key, and no key followed by
    `_` is part of another kernel's name (a launch key matches by
    substring)."""
    for stage in trace.MARKS:
        assert f"mark_{stage}" in _build.LAUNCHES
        assert launch_key(f"mark_{stage}_kernel(unsigned long long*)") == f"mark_{stage}"
    keys = [k for k in _build.LAUNCHES if not k.endswith("_w12")]
    for k in keys:
        assert [o for o in keys if o != k and k + "_" in o + "_kernel"] == []


def test_g2_kernels_count_under_their_own_keys():
    """The EC kernels' F_p2 instances (BN254 G2) map to their own keys, in
    the port's launch_key and the benchmark's (zkbench/tracing.py), though
    their names also hold a G1 key's operand source; G1's names stay
    G1's."""
    from zkbench import tracing

    names = {
        "scan_g2_gathered": "void (anonymous namespace)::scan_g2_gathered_kernel<8, true>("
                            "(anonymous namespace)::scan_gathered_fetch, unsigned int*)",
        "scan_g2_mixed": "void (anonymous namespace)::scan_g2_mixed_kernel<8, false>("
                         "(anonymous namespace)::scan_rows_fetch, unsigned int*)",
        "reduce_g2_buckets": "void (anonymous namespace)::reduce_g2_buckets_kernel<8>("
                             "(anonymous namespace)::reduce_buckets_fetch, unsigned int*)",
        "reduce_g2_cols": "void (anonymous namespace)::reduce_g2_cols_kernel<8>("
                          "(anonymous namespace)::reduce_rows_fetch, unsigned int*)",
        "ec_g2_add": "void (anonymous namespace)::ec_g2_add_kernel<8>(unsigned int const*)",
        "dbl_g2_n": "void (anonymous namespace)::dbl_g2_n_kernel<8>(unsigned int const*)",
        "fold_g2_horner": "void (anonymous namespace)::fold_g2_horner_kernel<8>(unsigned int*)",
        "scan_gathered": "void (anonymous namespace)::scan_mixed_kernel<8, true, "
                         "(anonymous namespace)::scan_gathered_fetch>(...)",
        "reduce_buckets": "void (anonymous namespace)::reduce_cols_kernel<8, "
                          "(anonymous namespace)::reduce_buckets_fetch>(...)",
    }
    for key, name in names.items():
        assert launch_key(name) == key
        assert tracing.launch_key(name, tuple(_build.LAUNCHES)) == key
    traced = traced_launches([(n, 2) for n in names.values()])
    check_trace(traced, {k: 2 for k in names}, "G1 and G2")


def test_no_profiler_no_span_and_no_mark_on_the_cpu():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("blaze.msm.call") is trace.span("blaze.tree.root", 3)
    with trace.span("blaze.msm.call"):
        pass
    before = dict(_build.LAUNCHES)
    clock = trace.StageClock()
    for stage in trace.MARKS:
        trace.mark(stage, torch.zeros(1))
        clock.mark(stage, torch.zeros(1))
    assert _build.LAUNCHES == before
    assert clock.ms() == {"sort": 0.0, "layout": 0.0, "scan": 0.0, "bucket": 0.0,
                          "stream": 0.0, "calls": 0}


def test_msm_call_span_holds_its_chunk_spans(monkeypatch):
    """A 2^10-point MSM in two chunks: blaze.msm.call around both chunks'
    spans and the accumulate and finalize spans."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    points, scalars, _, _ = tiled_msm_instance(spec, 16, seed=5)
    pts = cv.fq.to_mont(torch.from_numpy(np.tile(points, (64, 1, 1)).view(np.int32)))
    scal = np.tile(scalars, (64, 1))
    scal[:, 0] &= 0xFFF
    scal[:, 1:] = 0
    msm = MSM(cv, MSMConfig(chunk_log2=6))     # two windows: 2^(6 + 3) points a chunk
    threeW = 3 * cv.nwords

    def scan(pts, order, R, C, sortkey=None):
        lanes = order.shape[0] * R
        return (torch.zeros(C, threeW, lanes, dtype=torch.int32),
                torch.zeros(threeW, lanes, dtype=torch.int32))

    for name, fake in [("scan_gathered", scan), ("add", lambda x, y: x),
                       ("dbl_n", lambda x, k: x), ("reduce_cols", lambda rows: rows[0]),
                       ("reduce_buckets", lambda emitted, x, bounds, C, R, B: x),
                       ("fold_horner", lambda x, c: x[:, 0])]:
        monkeypatch.setattr(msm.kern, name, fake)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        msm(pts, torch.from_numpy(scal.view(np.int32)), window_bits=6, scalar_bits=12)
    found = spans(prof)
    (call,) = named(found, "blaze.msm.call")
    chunks = named(found, "blaze.msm.chunk")
    inner = chunks + named(found, "blaze.msm.accumulate") + named(found, "blaze.msm.finalize")
    assert len(chunks) == 2 and len(inner) == 4
    assert all(call[1] <= s[1] and s[2] <= call[2] for s in inner)
    assert not named(found, "blaze.msm.capture")          # no graph on the CPU


def test_precompute_and_multiple_spans(monkeypatch):
    """precompute_resident runs under blaze.msm.precompute; a precomputed
    MSM on resident operands holds one blaze.msm.multiple span per
    multiple inside its blaze.msm.call, each around its own chunks."""
    spec = CURVES["bn254"]
    cv = Curve(spec)
    W = cv.nwords
    msm = MSM(cv, MSMConfig(chunk_log2=3))
    threeW = 3 * W

    def scan(pts, order, R, C, sortkey=None):
        lanes = order.shape[0] * R
        return (torch.zeros(C, threeW, lanes, dtype=torch.int32),
                torch.zeros(threeW, lanes, dtype=torch.int32))

    for name, fake in [("scan_gathered", scan), ("add", lambda x, y: x),
                       ("dbl_n", lambda x, k: x), ("reduce_cols", lambda rows: rows[0]),
                       ("reduce_buckets", lambda emitted, x, bounds, C, R, B: x),
                       ("fold_horner", lambda x, c: x[:, 0])]:
        monkeypatch.setattr(msm.kern, name, fake)
    monkeypatch.setattr(cv, "to_affine", lambda p: p[..., :2, :])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        expanded = precompute_resident(cv, torch.zeros((2 * W, 16), dtype=torch.int32), 4)
        msm.msm_precomputed(expanded, torch.zeros((16, 16), dtype=torch.int32), 4,
                            window_bits=6)
    found = spans(prof)
    (pre,) = named(found, "blaze.msm.precompute")
    (call,) = named(found, "blaze.msm.call")
    multiples, chunks = named(found, "blaze.msm.multiple"), named(found, "blaze.msm.chunk")
    assert expanded.shape == (2 * W, 64) and pre[2] <= call[1]
    assert len(multiples) == 4 and len(chunks) == 8
    assert all(call[1] <= m[1] and m[2] <= call[2] for m in multiples)
    assert all(sum(m[1] <= c[1] and c[2] <= m[2] for c in chunks) == 2 for m in multiples)


def _same_state(self, state, *a, out=None, **k):
    if out is not None and out is not state:
        out.copy_(state)
        return out
    return state


def test_poseidon_lifecycle_spans_share_the_task_label(monkeypatch):
    monkeypatch.setattr(PoseidonKernels, "permute_lm", _same_state)
    height = 3
    client = PoseidonClient("bls12_381_fr", device="cpu")
    client.initialize(PoseidonInitializeParameters(tree_height=height))
    rng = np.random.default_rng(3)
    spec = FIELDS["bls12_381_fr"]
    words = rng.integers(0, 1 << 32, size=(8 ** (height - 1) * 11, spec.nwords),
                         dtype=np.uint64).astype(np.uint32)
    words[:, -1] &= 0x0FFFFFFF                           # below p
    client.set_data(memoryview(words).cast("B"))
    client.start_process()
    client.wait_result()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        client.start_process()
        client.wait_result()
        root = client.root
        raw = client.result_raw()
    assert root is not None and len(raw) == 64 * sum(8 ** i for i in range(height))
    found = spans(prof)
    labelled = {s[0] for s in found if "#" in s[0]}
    assert labelled == {"blaze.poseidon.start#1", "blaze.poseidon.wait#1",
                        "blaze.tree.root#1", "blaze.poseidon.result#1"}
    (start,) = named(found, "blaze.poseidon.start")
    levels = named(found, "blaze.tree.level")
    assert len(levels) == height - 1 and len(named(found, "blaze.tree.leaves")) == 1
    assert all(start[1] <= s[1] and s[2] <= start[2] for s in levels)
    t = client.timings
    assert t.set_data_s > 0 and t.start_s > 0 and t.wait_s > 0


def test_fused_ntt_spans_its_levels_and_twiddles(monkeypatch):
    spec = FIELDS["bn254_fr"]
    plan = FusedNTT(spec, 10, device="cpu")
    monkeypatch.setattr(plan.kern, "ntt_base", lambda x, *a, out, **k: out)
    monkeypatch.setattr(plan.kern, "twiddle_mul", lambda y, *a, out, **k: out)
    monkeypatch.setattr(plan.kern, "mul_lm", lambda y, *a, out, **k: out)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 32, size=(plan.n, spec.nwords), dtype=np.uint64).astype(np.uint32)
    x[:, -1] &= 0x0FFFFFFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.ntt(torch.from_numpy(x.view(np.int32)))
    found = spans(prof)
    (whole,) = named(found, "blaze.ntt.transform")
    parts = [named(found, f"blaze.ntt.{s}") for s in ("alloc", "level", "twiddle")]
    assert [len(p) for p in parts] == [1, len(plan.parts), len(plan.parts) - 1]
    assert all(whole[1] <= s[1] and s[2] <= whole[2] for p in parts for s in p)
