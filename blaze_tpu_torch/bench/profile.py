"""Kernel timing, speed of light and work accounting on the card.

The counterpart of blaze_tpu/bench/profile.py, and the one home of the
port's bounds, timers and work counts (chip_smoke.py and the scripts import
them from here):

  * `SpeedOfLight` / `SOL_TABLE` / `speed_of_light`: the card's limits,
    keyed by `torch.cuda.get_device_name()`; `check_card` holds the entry
    against what nvidia-smi and torch read on the card;
  * `bench_kernel`: one warm-up call, then CUDA events around groups of
    launches queued behind a spin of the card (`cuda_ms`), or host clocks
    around synchronous calls on the CPU; best and median;
  * the least time of a kernel's work at a shape (`kernel_work`,
    `work_bound_ms`: bytes over HBM bandwidth or 32-bit multiply-adds over
    the IMAD rate), K3/K5/K6's chain bound (`chain_bound_ms`), and the work
    of each primitive (`msm_work`, `ntt_work`, `poseidon_work`,
    `pipeline_work`), all as (bytes, IMADs);
  * `device_split`: one call under torch.profiler, its device time split
    by kernel and checked against the port's launch counters (trace.py's
    checks);
  * `scaling_efficiency`: throughput(N devices) / (N * throughput(1)).
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Callable, Sequence

import torch

from .. import _build
from ..hash.tree import LEAF_ARITY
from ..trace import check_trace, dev_us, device_ops, launch_key, traced_launches


@dataclasses.dataclass(frozen=True)
class SpeedOfLight:
    """One device's limits used for attainment accounting."""

    hbm_bytes_per_s: float       # memory bandwidth
    imad_per_clk_per_sm: int     # 32-bit integer multiply-adds per clock per SM
    sms: int
    max_sm_clock_mhz: float
    smem_per_sm_kib: float       # shared memory per SM
    int8_tc_ops_per_s: float = 0.0   # dense int8 tensor-core rate (0: none)

    @property
    def imad_per_s(self) -> float:
        return self.sms * self.imad_per_clk_per_sm * self.max_sm_clock_mhz * 1e6


# Key: torch.cuda.get_device_name().  The H100 SXM's data sheet (3.35 TB/s,
# 132 SMs, 228 KiB of shared memory per SM, 1,979 dense int8 TOP/s on the
# tensor cores), compute capability 9.0's IMAD rate, and the max SM clock
# nvidia-smi reads on the card (1980 MHz).  The
# "cpu" row is nominal, for tests: no device metric comes from it.
SOL_TABLE: dict[str, SpeedOfLight] = {
    "NVIDIA H100 80GB HBM3": SpeedOfLight(hbm_bytes_per_s=3.35e12, imad_per_clk_per_sm=64,
                                          sms=132, max_sm_clock_mhz=1980.0,
                                          smem_per_sm_kib=228.0, int8_tc_ops_per_s=1.979e15),
    "cpu": SpeedOfLight(hbm_bytes_per_s=20e9, imad_per_clk_per_sm=4, sms=1,
                        max_sm_clock_mhz=3000.0, smem_per_sm_kib=0.0),
}


def device_kind(device=None) -> str:
    """The SOL_TABLE key of `device` (default: the first card, else the CPU)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu"))
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def speed_of_light(kind: str | None = None) -> SpeedOfLight:
    """The limits of `kind` (default: device_kind()).  A device that is not
    in SOL_TABLE raises: any other row would hide it behind wrong limits."""
    kind = kind or device_kind()
    if kind not in SOL_TABLE:
        raise ValueError(f"no speed-of-light entry for {kind!r}: add its limits to "
                         f"SOL_TABLE (known: {sorted(SOL_TABLE)})")
    return SOL_TABLE[kind]


def smi(query: str) -> str:
    """One nvidia-smi field list of the first card, as CSV without header."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check_card(sol: SpeedOfLight, index: int = 0) -> dict:
    """Hold the table's entry against the card: its max SM clock
    (nvidia-smi), SM count and shared memory per SM (torch).  Raises
    RuntimeError where they differ; returns what was read."""
    props = torch.cuda.get_device_properties(index)
    smem = getattr(props, "shared_memory_per_multiprocessor", None)
    read = {"max_sm_clock_mhz": float(smi("clocks.max.sm").split()[0]),
            "sms": props.multi_processor_count,
            "smem_per_sm_kib": None if smem is None else smem / 1024}
    bad = {k: (v, getattr(sol, k)) for k, v in read.items()
           if v is not None and v != getattr(sol, k)}
    if bad:
        raise RuntimeError(f"{props.name}: the card differs from SOL_TABLE "
                           f"(read, table): {bad}")
    return read


# ------------------------------------------------------------------ timing
SPIN_CYCLES = 40_000_000      # ~20 ms of the card's clock
GROUPS = 5                    # bench_kernel's timed groups on the card


def _events_ms(fn: Callable, reps: int) -> float:
    """Mean ms of fn's work over `reps` calls: CUDA events around the calls,
    queued behind a spin of the card so that the host has queued them all
    before the first runs (else a kernel shorter than its launch from
    Python is timed at the host's pace)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn: Callable, reps: int) -> float:
    """Mean time (ms) of fn's work on the card over `reps` warm calls."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def wall_s(fn: Callable, iters: int, device) -> list:
    """Host seconds of `iters` calls of fn, each ended by a synchronise of
    the card when `device` is one."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


@dataclasses.dataclass
class KernelStats:
    """One benchmarked kernel: times, attainment and bound."""

    name: str
    compile_s: float
    best_s: float
    median_s: float
    reps: int
    bytes_accessed: int | None = None
    sol_fraction: float | None = None    # achieved bytes/s over HBM bandwidth
    imad_fraction: float | None = None   # achieved IMADs/s over the IMAD rate
    bound_ms: float | None = None        # least time of the work (work_bound_ms)
    bound_by: str | None = None          # "bytes" or "operations"
    bound_fraction: float | None = None  # bound_ms over the best time

    def summary(self) -> str:
        s = (f"{self.name}: best {self.best_s * 1e3:.3f} ms "
             f"(median {self.median_s * 1e3:.3f} ms, compile {self.compile_s:.1f} s)")
        if self.sol_fraction is not None:
            s += f", {100 * self.sol_fraction:.1f}% of HBM speed-of-light"
        if self.imad_fraction is not None:
            s += f", {100 * self.imad_fraction:.1f}% of the IMAD rate"
        if self.bound_ms is not None:
            s += (f", bound {self.bound_ms:.4g} ms by {self.bound_by} "
                  f"({100 * self.bound_fraction:.1f}% of best)")
        return s


def bench_kernel(
    fn: Callable,
    args: Sequence,
    name: str = "kernel",
    reps: int = 10,
    bytes_accessed: int | None = None,
    work: tuple | None = None,
) -> KernelStats:
    """Time fn(*args): one warm-up call (the build and first launch), then
    on a card (any CUDA tensor among args) GROUPS groups of `reps` launches,
    each timed by CUDA events behind a spin of the card, or on the CPU
    `reps` synchronous calls timed by the host clock.  `bytes_accessed`
    gives the HBM attainment; `work` = (bytes, IMADs) also the IMAD
    attainment and the bound on the device's SOL_TABLE row."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = next((a.device for a in tensors if a.is_cuda), torch.device("cpu"))
    t0 = time.perf_counter()
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    if dev.type == "cuda":
        times = [_events_ms(lambda: fn(*args), reps) / 1e3 for _ in range(GROUPS)]
    else:
        times = wall_s(lambda: fn(*args), reps, dev)
    best = min(times)
    sol = speed_of_light(device_kind(dev))
    if work is not None and bytes_accessed is None:
        bytes_accessed = work[0]
    stats = KernelStats(name=name, compile_s=compile_s, best_s=best,
                        median_s=statistics.median(times), reps=reps,
                        bytes_accessed=bytes_accessed)
    if bytes_accessed is not None:
        stats.sol_fraction = bytes_accessed / best / sol.hbm_bytes_per_s
    if work is not None:
        stats.imad_fraction = work[1] / best / sol.imad_per_s
        stats.bound_ms, stats.bound_by = bound_ms(work, sol)
        stats.bound_fraction = stats.bound_ms / (best * 1e3)
    return stats


def field_mul_traffic_bytes(batch: int, nwords: int) -> int:
    """Least HBM traffic of a batched field product: read a and b, write
    the product, each `nwords` 32-bit words per element.  (The JAX version
    counts 16-bit limbs stored in 32-bit words: twice this for a field.)"""
    return 3 * batch * nwords * 4


def scaling_efficiency(throughput_by_n: dict[int, float]) -> dict[int, float]:
    """{n_devices: throughput} -> {n_devices: efficiency vs linear}.

    The BASELINE.md target is >= 0.8 at every measured width."""
    if 1 not in throughput_by_n:
        raise ValueError("need the 1-device throughput as the reference")
    t1 = throughput_by_n[1]
    return {n: t / (n * t1) for n, t in sorted(throughput_by_n.items())}


# ------------------------------------------------------------------ bounds
def product_imads(W: int) -> int:
    """32-bit multiply-adds of one W-word Montgomery product: 2W^2 full
    32x32->64 products (2 IMADs each) and W low products."""
    return 4 * W * W + W


def fp2_product_imads(W: int) -> int:
    """32-bit multiply-adds of one F_p2 product over W-word F_p by
    Karatsuba with lazy reduction: three unreduced products (2W^2 each) and
    two REDCs (2W^2 + W each)."""
    return 3 * 2 * W * W + 2 * (2 * W * W + W)


def poseidon_imads(shape: dict, W: int, sparse: bool) -> int:
    """32-bit multiply-adds of one Poseidon state: 3 full products per
    S-box (r_f t + r_p of them) and t more with convert_in; a dense mix is
    t^2 unreduced products (2W^2 each) and t row REDCs (2W^2 + W); a sparse
    partial round's mix is t unreduced products, one REDC and t - 1 full
    products."""
    t, r_f, r_p = shape["t"], shape["r_f"], shape["r_p"]
    full, unreduced, redc = product_imads(W), 2 * W * W, 2 * W * W + W
    n = (3 * (r_f * t + r_p) + t * shape["convert_in"]) * full
    n += r_f * t * (t * unreduced + redc)
    if sparse:
        return n + r_p * (t * unreduced + redc + (t - 1) * full)
    return n + r_p * t * (t * unreduced + redc)


def kernel_work(name: str, shape: dict, W: int, degree: int = 1) -> tuple:
    """(bytes, IMADs) of one launch of kernel `name` (a launch-counter key;
    for an EC kernel on F_p2 coordinates, degree 2, the G1 key of its
    kernel) at `shape` on W-word elements (the EC kernels' coordinates:
    `degree` of them): the bytes it must move (inputs read once, outputs
    written once) and the multiply-adds of the products it must make, an
    F_p2 product fp2_product_imads(W).  Alg 8 (mixed add) has 13 products, alg 7 (complete add) 14.
    A K-point NTT needs (K/2) log2 K - (K - 1) products per lane: a
    butterfly whose twiddle is W^0 needs none (all of stage 0, K/2^(s+1) of
    stage s; K7 skips them).  K9 needs two per element, K8 one per operand
    past the first.  KF (field_ew) makes no product: its carry chains are
    a few instructions per word, so bytes bound it."""
    per_mul = product_imads(W) if degree == 1 else fp2_product_imads(W)
    pt = 3 * degree * W * 4                       # bytes of one projective point
    el = W * 4                                    # bytes of one field element
    if name == "poseidon_perm":
        return (2 * shape["t"] * shape["B"] * el,
                shape["B"] * poseidon_imads(shape, W, shape["sparse"]))
    if name == "ntt_base":
        K, N = shape["K"], shape["lanes"]
        muls = ((K // 2) * (K.bit_length() - 1) - (K - 1)) * N
        nbytes = 2 * K * N * el + K * el
    elif name == "twiddle_mul":
        A, J, S, B = shape["A"], shape["J"], shape["S"], shape["B"]
        muls = 2 * A * J * S * B
        nbytes = 2 * A * J * S * B * el + A * (J + S) * el
    elif name == "mul_lm":
        M, N, k = shape["M"], shape["N"], shape["operands"]
        muls, nbytes = (k - 1) * M * N, (k + 1) * M * N * el
    elif name == "mont_mul":
        muls, nbytes = shape["M"], field_mul_traffic_bytes(shape["M"], W)
    elif name == "field_ew":
        muls, nbytes = 0, (shape["operands"] + 1) * shape["M"] * el
    elif name == "scan_mixed":
        C, B = shape["C"], shape["B"]
        muls = 13 * C * B
        nbytes = C * B * (2 * pt // 3 + 4 * shape.get("signed", 0)) + C * B * pt + B * pt
    elif name == "scan_gathered":
        # the chunk's N points, and its G windows' order (and sort keys) of
        # int64, read once
        C, B, N, G = shape["C"], shape["B"], shape["N"], shape["G"]
        muls = 13 * C * B
        nbytes = N * 2 * pt // 3 + G * N * 8 * (1 + shape.get("signed", 0)) + C * B * pt + B * pt
    elif name == "ec_add":
        muls, nbytes = 14 * shape["B"], 3 * shape["B"] * pt
    elif name == "reduce_cols":
        C, B = shape["C"], shape["B"]
        muls, nbytes = 14 * C * B, (C + 1) * B * pt
    elif name == "reduce_buckets":
        # each operand (a bucket's carry or local; the pads none) and its
        # window's int64 bound read once
        C, B, G, nb = shape["C"], shape["B"], shape["G"], shape["buckets"]
        muls = 14 * C * B
        nbytes = 2 * G * (nb - 1) * pt + G * nb * 8 + B * pt
    elif name == "dbl_n":
        muls, nbytes = 14 * shape["k"] * shape["B"], 2 * shape["B"] * pt
    elif name == "fold_horner":
        muls = 14 * (shape["Wn"] - 1) * (shape["c"] + 1)
        nbytes = (shape["Wn"] + 1) * pt
    else:
        raise ValueError(f"no work count for kernel {name!r}")
    return nbytes, muls * per_mul


def bound_ms(work: tuple, sol: SpeedOfLight) -> tuple:
    """(least ms, "bytes" or "operations") of `work` = (bytes, IMADs): the
    larger of the bytes over HBM bandwidth and the IMADs over the IMAD
    rate."""
    nbytes, imads = work
    t_ops = imads / sol.imad_per_s * 1e3
    t_bytes = nbytes / sol.hbm_bytes_per_s * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def work_bound_ms(name: str, shape: dict, W: int, sol: SpeedOfLight, degree: int = 1) -> tuple:
    """Least time of kernel `name`'s work at `shape` (kernel_work) on the
    device `sol`: (ms, "bytes" or "operations")."""
    return bound_ms(kernel_work(name, shape, W, degree), sol)


CHAIN_PRODUCTS = 3     # dependent products per group op on the team (ec_team.cuh)
CHAINED = ("ec_add", "dbl_n", "fold_horner")


def product_latency_us(spec, device, n: int = 4096) -> float:
    """One lazy product's latency (us) on one thread of the card: n
    dependent carry-chain products in one launch (blz_product_chain, CUDA
    events), its words first held against the plain products at n = 16.
    On F_p2 coordinates (BN254's G2) one F_p2 product."""
    from ..curves.kernels import ECKernels
    from ..oracle.gen import rand_words

    k = ECKernels.for_curve(spec)
    x, y = rand_words(spec.fq, (2 * spec.degree, spec.fq.nwords), 7, device).reshape(2, -1)
    if not torch.equal(k.product_chain(x, y, 16), k.product_chain_plain(x, y, 16)):
        raise AssertionError("blz_product_chain differs from the plain products")
    return cuda_ms(lambda: k.product_chain(x, y, n), 3) * 1e3 / n


def chain_bound_ms(name: str, shape: dict, latency_us: float) -> float:
    """K3's, K5's and K6's chain bound: the products on the team's critical
    path (CHAIN_PRODUCTS per group op; K3 one group op per lane, K5 one
    per doubling, K6 one per step) times one product's latency."""
    if name == "ec_add":
        ops = 1
    elif name == "dbl_n":
        ops = shape["k"]
    else:
        ops = max((shape["Wn"] - 1) * (shape["c"] + 1), 1)
    return CHAIN_PRODUCTS * ops * latency_us / 1e3


# ------------------------------------------------------ work per primitive
def msm_work(spec, n: int, window_bits: int) -> tuple:
    """(bytes, IMADs) of an n-point MSM on curve `spec` with c-bit windows,
    c = window_bits, by the bucket method, whatever implements it.  Bytes:
    one read of the resident operands, n (2W 4 + Ls 2), 128 B per BLS12-381
    point.  Products: every point added into one bucket per window, a mixed
    add of 13 products (alg 8, as K2's bound counts it; bench.py counts 11),
    nwin n of them (nwin = ceil(bits(r) / c)); per window the running-sum
    bucket reduction, 2 (2^c - 1) complete adds of 14 products; the Horner
    fold of the windows, (nwin - 1)(c + 1) complete adds or doublings of
    14.  Each product costs product_imads(W) on the base field's W words."""
    W, Ls = spec.fq.nwords, spec.fr.nlimbs
    c = window_bits
    nwin = -(-spec.fr.bits // c)
    products = nwin * (13 * n + 14 * 2 * ((1 << c) - 1)) + 14 * (nwin - 1) * (c + 1)
    return n * (2 * W * 4 + Ls * 2), products * product_imads(W)


def ntt_work(spec, logn: int) -> tuple:
    """(bytes, IMADs) of one 2^logn-point NTT over field `spec`, whatever
    implements it.  Bytes: the n-element buffer read once and written once,
    2 n 4W (2 n 32 B on an 8-word field).  Products: a radix-2 transform's
    (n/2) log2 n twiddle products less the n - 1 whose twiddle is W^0,
    product_imads(W) each."""
    n = 1 << logn
    products = (n // 2) * logn - (n - 1)
    return 2 * n * spec.nwords * 4, products * product_imads(spec.nwords)


def poseidon_work(spec, height: int, leaf_params, node_params) -> tuple:
    """(bytes, IMADs) of one 8-ary TREE_C build of `height` over field
    `spec`, whatever implements it.  Bytes: the 11-element leaf columns read
    once and the leaf hashes written once, nleaves (11 + 1) 4W (32 B
    elements).  Products: one leaf permutation (leaf_params, t = 12) per
    leaf with its inputs brought into Montgomery form (t products), one node
    permutation (node_params, t = 9) per node above the leaves, each on the
    sparse schedule (poseidon_imads), and one product per record to bring
    every hash out of Montgomery form."""
    W = spec.nwords
    nleaves = 8 ** (height - 1)
    nodes = (nleaves - 1) // 7
    records = nleaves + nodes

    def per_state(params, convert_in):
        return poseidon_imads({"t": params.t, "r_f": params.r_f, "r_p": params.r_p,
                               "convert_in": convert_in}, W, True)

    imads = (nleaves * per_state(leaf_params, 1) + nodes * per_state(node_params, 0)
             + records * product_imads(W))
    return nleaves * (LEAF_ARITY + 1) * W * 4, imads


def pipeline_work(curve_spec, ntt_logn: int, msm_logn: int, window_bits: int) -> tuple:
    """(bytes, IMADs) of one proof batch: ntt_work of the 2^ntt_logn
    coefficients on the curve's scalar field plus msm_work of the first
    2^msm_logn spectral values as scalars."""
    nb, ni = ntt_work(curve_spec.fr, ntt_logn)
    mb, mi = msm_work(curve_spec, 1 << msm_logn, window_bits)
    return nb + mb, ni + mi


# ---------------------------------------------------------- device traces
SPLIT_KERNELS = ("ntt_base", "mul_lm", "twiddle_mul")
SPLIT = (*SPLIT_KERNELS, "nccl", "other")


def kernel_of(key: str) -> str:
    """The kernel of a launch-counter key, whatever its build's width."""
    return key.removesuffix("_w12")


def device_split(fn: Callable) -> dict:
    """fn() once under torch.profiler: the device time and count of K7
    (ntt_base_kernel), K8 (mul_lm_*kernel), K9 (twiddle_mul_kernel) at
    either width, NCCL's collectives (kernels named nccl*) and every other
    device operation (a copy, a fill, a gather, listed in other_ops), and
    the wall ms.  Raises
    TraceLost when the trace holds fewer events of a port kernel than its
    launch counter rose by in the window: on the H100 machine torch.profiler
    drops more of the card's events the older the process is, from about
    40 s on (PERF.md §7), so call it early in a process of its own."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    split = {k: [0, 0.0] for k in SPLIT}
    others = []
    # the device's own events: the aten ops above them report the same time
    events = device_ops(prof)
    check_trace(traced_launches((e.key, e.count) for e in events), launched, "device_split")
    for e in events:
        lk = launch_key(e.key)
        lk = lk and kernel_of(lk)
        key = lk if lk in SPLIT_KERNELS else ("nccl" if "nccl" in e.key.lower() else "other")
        split[key][0] += e.count
        split[key][1] += dev_us(e) / 1e3
        if key == "other":
            others.append({"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3})
    return {"wall_ms": wall * 1e3, "device_ms": sum(v[1] for v in split.values()),
            **{f"{k}_launches": v[0] for k, v in split.items()},
            **{f"{k}_ms": v[1] for k, v in split.items()}, "other_ops": others}
