"""The MSM, NTT and Poseidon clients — the ingo_msm, ingo_ntt and ingo_hash
module analogs.

API shape follows the reference's client 1:1 (init struct -> lifecycle
methods -> wire-format results), with the CUDA stream supplying the
queue/poll machinery the FPGA exposes as registers.

For the MSM both lifecycle orders work.  set_data -> start_process stages the full
operand set, then runs the MSM.  The reference's own order — initialize ->
start_process -> set_data (the FPGA consumes the DMA stream after the task
is queued, msm_api.rs:113-220) — opens a STREAMING task: each set_data chunk
is transferred and its per-window partials computed at once, so the full
operand set is never resident at once.

MSM <- blaze/src/ingo_msm/msm_api.rs
NTT <- blaze/src/ingo_ntt/ntt_api.rs
Poseidon <- blaze/src/ingo_hash/poseidon_api.rs
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..curves import (
    CURVE_ALIASES,
    CURVES,
    Curve,
    decode_affine_points,
    decode_scalars,
    encode_projective_result,
)
from ..fields import FIELDS, FieldSpec
from ..hash import (
    ARITY,
    LEAF_ARITY,
    MerkleTreeBuilder,
    TreeMode,
    TreeResult,
    base_layer_size,
    params_from_csv,
)
from ..msm import (
    MSM,
    MSMConfig,
    default_window_bits,
    points_from_resident,
    points_to_resident,
    scalars_to_resident,
    split_scalars,
)
from ..ntt import make_ntt
from .device import DeviceContext
from .primitive import DriverPrimitive, ImageParams
from ..trace import span
from ..utils.errors import (
    BlazeError,
    DataError,
    DeviceError,
    InvalidPrimitiveParam,
    NotReady,
)
from ..utils.misc import elide_payload, hard_sync, retry

log = logging.getLogger("blaze_tpu_torch.clients")


# "It is important to check the firewall status after a large transfer"
# (dclient.rs:241-243; status dump 566-579): transfers at least this big
# get an automatic post-transfer health consult.
_HEALTH_CHECK_BYTES = 256 * 1024 * 1024


def _as_i32(arr: np.ndarray) -> torch.Tensor:
    """uint32 host array -> int32 tensor with the same bits (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32))


def _host_words(data, W: int, lead: tuple, what: str) -> np.ndarray:
    """An element array -> uint32 words (..., W).  It may come in the
    reference's form, 16-bit limbs (..., 2W) (blaze_tpu's MSMInput.points
    and NTTInput.data), or in 32-bit words (..., W): the last axis says
    which.  `lead` gives the other axes, None for any length.  Any other
    shape, or a limb of 16 bits or more, raises DataError."""
    arr = np.asarray(data)
    ok = arr.ndim == len(lead) + 1 and all(
        want is None or got == want for got, want in zip(arr.shape, lead))
    if not ok or arr.shape[-1] not in (W, 2 * W):
        dims = ", ".join("n" if d is None else str(d) for d in lead)
        raise DataError(f"{what}: want ({dims}, {2 * W}) 16-bit limbs or ({dims}, {W}) "
                        f"words, got shape {arr.shape}")
    if arr.shape[-1] == W:
        return np.ascontiguousarray(arr, dtype=np.uint32)
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
        raise DataError(f"{what}: a 16-bit limb is out of range")
    return np.ascontiguousarray(arr, dtype="<u2").view("<u4")


def _device_put(x: torch.Tensor, ctx: DeviceContext) -> torch.Tensor:
    """Transfer with the reference's retry semantics (utils.rs:133-147):
    transient failures get N attempts with a short backoff.  A transfer
    that still fails surfaces as the typed DeviceError (the WriteError
    analog, error.rs:7-10).  Large transfers are followed by an automatic
    health check (the post-transfer firewall status consult,
    dclient.rs:241-279)."""
    try:
        out = retry(lambda: x.to(ctx.device), times=3, sleep_s=0.5)
    except BlazeError:
        raise
    except Exception as e:
        raise DeviceError(
            f"transfer failed after retries: {e}", buffer=str(ctx.device)
        ) from e
    if x.numel() * x.element_size() >= _HEALTH_CHECK_BYTES:
        h = ctx.health()
        if not h.ok():
            raise DeviceError(
                f"post-transfer health check failed: {h}", buffer=str(ctx.device)
            )
    return out


def _resolve_curve(curve) -> Curve:
    if isinstance(curve, Curve):
        return curve
    if curve in CURVE_ALIASES:
        return Curve(CURVE_ALIASES[curve])
    return Curve(CURVES[curve])


@dataclasses.dataclass
class MSMInit:
    """msm_api.rs:16-22 analog."""

    curve: str = "bls12_381"
    mem_type: str = "dma"           # 'dma' | 'hbm' (PointMemoryType)
    precompute_factor: int = 1      # reference uses 1 or 8 (msm_api.rs:39-40)


@dataclasses.dataclass
class MSMParams:
    """msm_api.rs:25-30 analog."""

    nof_elements: int
    hbm_point_addr: Optional[str] = None  # cache key (HBM addr analog)


@dataclasses.dataclass
class MSMInput:
    """msm_api.rs:32-37 analog; three set_data modes (README.md:83-113)."""

    scalars: object                  # bytes or (N, Ls) uint32 16-bit limbs
    # bytes, or canonical (N, 2, L) 16-bit limbs (the reference's form) or
    # (N, 2, W) 32-bit words
    points: Optional[object] = None
    params: Optional[MSMParams] = None


@dataclasses.dataclass
class MSMResult:
    """msm_api.rs result analog: z||y||x LE bytes + task label."""

    result: bytes
    label: int


class MSMClient(DriverPrimitive):
    trace_name = "msm"

    def __init__(self, init: MSMInit, ctx: Optional[DeviceContext] = None,
                 config: Optional[MSMConfig] = None, device: Optional[str] = None):
        super().__init__()
        self.init = init
        self.ctx = ctx or DeviceContext(device=device)
        self.curve = _resolve_curve(init.curve)
        self.engine = MSM(self.curve, config)
        self._params: Optional[MSMParams] = None
        # Operands live in the resident layouts (msm/residency.py): points
        # (2W, N) int32 Montgomery words, scalars (Ls, N) int32 limbs.
        self._points = None
        self._scalars = None
        self._scalar_bits = None       # < fr.bits in precompute mode
        # In-flight result queue: (label, device tensor) FIFO — the
        # reference's multi-deep task queue (msm_hw_code.rs:19-25), where a
        # new start_process never clobbers an unpopped result.
        self._inflight: collections.deque = collections.deque()
        self._hbm_cache: dict = {}     # persistent point residency (mode 3)
        # Open streaming task (start_process before set_data — the
        # reference's lifecycle order, msm_api.rs:113-217): chunks are
        # consumed as they arrive, per-window partials accumulate on
        # device, the fold runs at wait_result.
        self._stream: Optional[dict] = None
        # set_data, start_process, wait_result and result read-modify-write
        # _stream and the queues: a feeder thread and a drainer thread may
        # share the client, as the reference's DMA thread does
        self._lock = threading.RLock()

    def loaded_binary_parameters(self) -> ImageParams:
        spec = self.curve.spec
        return ImageParams(
            "msm",
            {
                "curve": spec.name,
                "point_bytes": spec.point_bytes,
                "result_bytes": spec.result_bytes,
                "scalar_bytes": spec.scalar_bytes,
                "precompute_factor": self.init.precompute_factor,
                "window_bits": self.engine.config.window_bits,
                "mem_type": self.init.mem_type,
            },
        )

    def initialize(self, param: MSMParams) -> None:
        """Set task size / point source (msm_api.rs:72-111)."""
        self._params = param

    # ------------------------------------------------------ operand staging
    def _stage_scalars(self, scalars):
        """Wire bytes or limbs -> (host limb count, resident device scalars,
        scalar_bits or None), sliced per precomputed multiple when k > 1
        (msm_api.rs:39-40 windowing)."""
        spec = self.curve.spec
        if isinstance(scalars, (bytes, bytearray, memoryview)):
            scal = decode_scalars(scalars, spec)
        else:
            scal = np.asarray(scalars, dtype=np.uint32)
            if scal.ndim != 2 or scal.shape[1] != spec.fr.nlimbs:
                raise DataError(f"scalars: want (n, {spec.fr.nlimbs}) 16-bit limbs, "
                                f"got shape {scal.shape}")
        n = scal.shape[0]
        st = _as_i32(scal)
        bits = None
        k = self.init.precompute_factor
        if k > 1:
            st, bits = split_scalars(st, k, spec.fr.bits)
        return n, _device_put(scalars_to_resident(st), self.ctx), bits

    def _stage_points(self, points, n: Optional[int] = None) -> torch.Tensor:
        """Wire bytes, limbs or words for n bases (k*n points; any multiple
        of k when n is None) -> resident device points, multiple-major."""
        spec = self.curve.spec
        k = self.init.precompute_factor
        if isinstance(points, (bytes, bytearray, memoryview)):
            pts = decode_affine_points(points, spec)
        else:
            pts = _host_words(points, spec.fq.nwords, (None, 2), "points")
        if n is None:
            n = pts.shape[0] // k
        if pts.shape[0] != k * n:
            raise InvalidPrimitiveParam(
                f"want {k * n} points (precompute_factor={k}), got {pts.shape[0]}"
            )
        if k > 1:
            # Wire order is point-major — each base followed by its k-1
            # multiples (tests/msm/mod.rs:360-380); the engine wants
            # multiple-major slices (msm/precompute.py).
            pts = pts.reshape(n, k, 2, -1).transpose(1, 0, 2, 3).reshape(k * n, 2, -1)
        return points_to_resident(self.curve, _device_put(_as_i32(pts), self.ctx))

    def _cached_points(self, key, n: int) -> torch.Tensor:
        """The resident points cached under `key`, checked to hold the k*n
        multiple-major columns a task over n bases reads."""
        if key is None or key not in self._hbm_cache:
            raise NotReady(
                f"scalars-only set_data needs points cached under hbm_point_addr (key={key!r})"
            )
        cache = self._hbm_cache[key]
        k = self.init.precompute_factor
        if cache.shape[1] != k * n:
            raise InvalidPrimitiveParam(
                f"cache {key!r} holds {cache.shape[1]} points, the task needs "
                f"{k * n} (nof_elements={n}, precompute_factor={k})"
            )
        return cache

    def set_data(self, input: MSMInput) -> None:
        """Three modes (msm_api.rs:122-220):
        1. points + scalars (DMA);
        2. points cached under a key + scalars (HBM load);
        3. scalars only, points reused from cache (HBM reuse).

        With an OPEN STREAMING TASK (start_process called first — the
        reference's order, msm_api.rs:156-217) each call stages one chunk
        and computes its per-window partials at once, so the full operand
        set never has to be resident."""
        with self._lock:
            if self._stream is not None:
                return self._set_data_stream(input)
            return self._set_data_staged(input)

    def _set_data_staged(self, input: MSMInput) -> None:
        with self._timed("set_data_s"):
            params = input.params or self._params
            if params is None:
                raise NotReady("initialize() first (no MSMParams)")
            self._params = params
            log.debug("set_data scalars=%s points=%s",
                      elide_payload(input.scalars), elide_payload(input.points))
            n, sdev, bits = self._stage_scalars(input.scalars)
            if n != params.nof_elements:
                raise InvalidPrimitiveParam(
                    f"scalars {n} != nof_elements {params.nof_elements}"
                )
            self._scalars, self._scalar_bits = sdev, bits
            key = params.hbm_point_addr
            if input.points is not None:
                dev = self._stage_points(input.points, n)
                if key is not None:
                    self._hbm_cache[key] = dev      # mode 2: load-to-HBM
                self._points = dev
            else:
                self._points = self._cached_points(key, n)  # mode 3: reuse

    def _set_data_stream(self, input: MSMInput) -> None:
        """One streamed chunk: stage it, then compute and accumulate the
        window partials of each 2^chunk_log2 slice of it, as MSM.__call__
        slices a large input.  Caller holds the lock."""
        if input.params is not None:
            raise InvalidPrimitiveParam(
                "a streamed chunk cannot carry params: the open task's were "
                "fixed by initialize()"
            )
        with self._timed("set_data_s", self._stream["label"]):
            st = self._stream
            params = self._params
            nchunk, sdev, scalar_bits = self._stage_scalars(input.scalars)
            if st["consumed"] + nchunk > params.nof_elements:
                raise InvalidPrimitiveParam(
                    f"stream overflow: {st['consumed']} + {nchunk} > "
                    f"{params.nof_elements}"
                )
            if input.points is not None:
                pdev = self._stage_points(input.points, nchunk)
            else:
                cache = self._cached_points(params.hbm_point_addr, params.nof_elements)
                lo, hi = st["consumed"], st["consumed"] + nchunk
                k = self.init.precompute_factor
                if k > 1:
                    # cache is multiple-major over the FULL base set:
                    # gather this chunk's columns for every multiple
                    nb = params.nof_elements
                    idx = torch.as_tensor(np.concatenate(
                        [m * nb + np.arange(lo, hi) for m in range(k)]
                    ), device=cache.device)
                    pdev = cache[:, idx]
                else:
                    pdev = cache[:, lo:hi]

            step = 1 << self.engine.config.chunk_log2
            for a in range(0, pdev.shape[1], step):
                part = self.engine.msm_partial(pdev[:, a:a + step], sdev[:, a:a + step],
                                               st["c"], scalar_bits)
                st["wsums"] = self.engine.accumulate(st["wsums"], part)
            st["consumed"] += nchunk

    # ------------------------------------------------------------ lifecycle
    def start_process(self, param=None) -> None:
        """Queue the task (PUSH_MSM_TASK analog, msm_api.rs:113-120); may be
        called repeatedly — each task joins the in-flight queue with its
        label.

        Called BEFORE set_data (with a task size from initialize()), it
        opens a streaming task — the reference's own order (initialize ->
        start_process -> set_data, msm_api.rs:113-217)."""
        with self._lock:
            self._start_process()

    def _start_process(self) -> None:
        if self._stream is not None:
            raise NotReady(
                f"streaming task open ({self._stream['consumed']} of "
                f"{self._params.nof_elements} elements fed)"
            )
        if self._points is None or self._scalars is None:
            if self._params is None:
                raise NotReady("set_data() first")
            with self._timed("start_s"):
                n = self._params.nof_elements
                c = min(self.engine.config.window_bits, default_window_bits(n))
                self._stream = {
                    "label": self._push_task(),
                    "wsums": None,
                    "consumed": 0,
                    "c": c,
                }
            return
        with self._timed("start_s"):
            label = self._push_task()
            out = self.engine(
                self._points, self._scalars, scalar_bits=self._scalar_bits
            )
            self._inflight.append((label, out))

    def wait_result(self) -> None:
        """Block until the oldest queued task is done (RESULT_VALID poll
        analog, msm_api.rs:222-238).  An open streaming task is closed
        here: all declared elements must have been fed, the accumulated
        window partials are folded, and the device is synchronized."""
        with self._lock:
            self._wait_result()

    def _wait_result(self) -> None:
        if self._stream is not None:
            st = self._stream
            n = self._params.nof_elements
            if st["consumed"] < n:
                raise NotReady(f"streamed {st['consumed']} of {n} elements")
            with self._timed("wait_s", st["label"]):
                out = self.engine.finalize(st["wsums"], st["c"])
                self._inflight.append((st["label"], out))
                self._stream = None
                hard_sync(out)
            return
        if not self._inflight:
            return
        with self._timed("wait_s", self._inflight[0][0]):
            hard_sync(self._inflight[0][1])

    def result(self, param=None) -> Optional[MSMResult]:
        """Pop the oldest completed task (POP_RESULT, msm_api.rs:240-274)."""
        with self._lock:
            if self._stream is not None:
                self._wait_result()     # close the streaming task (fold + sync)
            if not self._inflight:
                return None
            self._wait_result()
            label, out = self._inflight.popleft()
            popped = self._pop_task()
        proj = self.curve.fq.from_mont(out)            # (3, W) canonical
        raw = encode_projective_result(
            proj.cpu().numpy().view(np.uint32), self.curve.spec
        )
        if popped is not None and popped != label:
            # FIFO divergence between the task-label queue and the
            # in-flight result queue is a framework bug, not a user error.
            raise DeviceError(
                f"task-label FIFO out of sync: popped {popped}, "
                f"result label {label}"
            )
        return MSMResult(result=raw, label=label)

    # -------------------------------------------------------- HBM helpers
    def load_data_to_hbm(self, key: str, points) -> None:
        """Explicit point residency (msm_api.rs:299-311): wire order, each
        base followed by its precompute_factor - 1 multiples, stored in the
        engine's multiple-major layout as the set_data path stores it."""
        self._hbm_cache[key] = self._stage_points(points)

    def get_data_from_hbm(self, key: str) -> np.ndarray:
        """Read back cached points (msm_api.rs:313-322) in the reference's
        form: (N, 2, L) uint32 canonical 16-bit limbs, L = 2W."""
        dev = points_from_resident(self.curve, self._hbm_cache[key])
        words = self.curve.fq.from_mont(dev).cpu().numpy().view(np.uint32)
        return np.ascontiguousarray(words).view("<u2").astype(np.uint32)

    def is_msm_engine_ready(self) -> bool:
        return not self._inflight and self._stream is None

    def get_api(self) -> dict:
        """Register-dump analog (msm_api.rs:324-330)."""
        return {
            "pending_tasks": self.pending_tasks,
            "task_label": self.task_label,
            "streamed_elements": (
                None if self._stream is None else self._stream["consumed"]
            ),
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }


# ============================================================== NTT client
@dataclasses.dataclass
class NTTInit:
    """ntt_api.rs analog; size is configurable here (fixed 2^27 there)."""

    field: object                  # FieldSpec or name in fields.FIELDS
    logn: int


@dataclasses.dataclass
class NTTInput:
    """ntt_api.rs:72-87 analog: raw LE bytes + host buffer index."""

    # bytes, or canonical (n, L) 16-bit limbs (the reference's form) or
    # (n, W) 32-bit words
    data: object
    buf_host: int = 0              # double-buffer slot (ntt_data.rs:54-56)


class NTTClient(DriverPrimitive):
    """Double-buffered NTT: two device slots, start/wait per slot — the
    pipelined flow of integration_ntt.rs:103-136.  Wire elements are the
    field's 4W bytes: 32 on the scalar fields, 48 on bls12_377_fq (6 GiB per
    slot at 2^27).

    No Montgomery conversion pass runs, at any size: canonical bytes in give
    canonical bytes out.  The twiddles are Montgomery representatives, so the
    linear map computed in representation space sends representatives to
    representatives — input words c represent c/R, output words are
    R*(NTT(c)/R) = NTT(c).  The bytes equal blaze_tpu's client, whose
    small-size path converts explicitly.

    On the card every slot has a pinned host buffer and the copies run on a
    side stream: a pageable copy on the compute stream would queue behind
    the running transform and block the host.  `start_process` makes the
    compute stream wait for the slot's upload, enqueues the transform and
    returns; `wait_result(buf)` waits on that slot's event only; `result(buf)`
    drains through the slot's pinned buffer once that slot is done, while
    the other slot keeps computing.
    """

    trace_name = "ntt"

    NOF_BUFFERS = 2

    def __init__(self, init: NTTInit, ctx: Optional[DeviceContext] = None,
                 inverse: bool = False, device: Optional[str] = None):
        super().__init__()
        self.spec: FieldSpec = (
            init.field if isinstance(init.field, FieldSpec) else FIELDS[init.field]
        )
        self.logn = init.logn
        self.ctx = ctx or DeviceContext(device=device)
        self.plan = make_ntt(self.spec, init.logn, device=self.ctx.device)
        self.inverse = inverse
        self._cuda = self.ctx.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.ctx.device) if self._cuda else None
        self._slots = [None] * self.NOF_BUFFERS      # staged: (input, upload event)
        self._results = [None] * self.NOF_BUFFERS    # in flight: (output, done event)
        self._pinned = [None] * self.NOF_BUFFERS     # per-slot pinned host buffers
        self._pinned_busy = [None] * self.NOF_BUFFERS  # last copy through each

    def loaded_binary_parameters(self) -> ImageParams:
        return ImageParams(
            "ntt",
            {
                "field": self.spec.name,
                "logn": self.logn,
                "element_bytes": self.spec.nbytes,
                "buffers": self.NOF_BUFFERS,
            },
        )

    def initialize(self, param=None) -> None:
        """No-op (the reference writes disabled debug regs, ntt_api.rs:37-56)."""

    def _words(self, data) -> np.ndarray:
        """Wire bytes (a zero-copy view), limbs or words -> (n, W) int32
        words."""
        n, W = 1 << self.logn, self.spec.nwords
        if isinstance(data, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(data, dtype=np.uint8)
            if raw.size % self.spec.nbytes:
                raise DataError(
                    f"{raw.size} B is not a multiple of the "
                    f"{self.spec.nbytes} B element size"
                )
            words = raw.view("<u4").reshape(-1, W)
        else:
            words = _host_words(data, W, (None,), "NTT data")
        if words.shape[0] != n:
            raise InvalidPrimitiveParam(f"want {n} elements, got {words.shape[0]}")
        return words.view(np.int32)

    def _staging(self, buf: int) -> torch.Tensor:
        """The slot's pinned host buffer, once its last copy has finished."""
        if self._pinned[buf] is None:
            self._pinned[buf] = torch.empty(
                (1 << self.logn, self.spec.nwords), dtype=torch.int32, pin_memory=True
            )
        elif self._pinned_busy[buf] is not None:
            self._pinned_busy[buf].synchronize()
        return self._pinned[buf]

    def set_data(self, input: NTTInput) -> None:
        """Stage one input vector in a slot (ntt_api.rs:72-87)."""
        with self._timed("set_data_s"):
            buf = input.buf_host
            words = self._words(input.data)
            if not self._cuda:
                self._slots[buf] = (torch.from_numpy(words.copy()), None)
                return
            pinned = self._staging(buf)
            pinned.numpy()[:] = words
            with torch.cuda.stream(self._copy_stream):
                dev = torch.empty(pinned.shape, dtype=torch.int32, device=self.ctx.device)
                dev.copy_(pinned, non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record()
            self._pinned_busy[buf] = uploaded
            self._slots[buf] = (dev, uploaded)

    def start_process(self, buf_kernel: int = 0) -> None:
        """Enqueue the transform on a buffer and return (AP_CTRL start,
        ntt_api.rs:58-70).  The slot's input is consumed: the client drops
        it, as blaze_tpu donates it."""
        slot = self._slots[buf_kernel]
        if slot is None:
            raise NotReady(f"buffer {buf_kernel} empty")
        self._slots[buf_kernel] = None
        with self._timed("start_s"):
            self._push_task()
            x, uploaded = slot
            fn = self.plan.intt if self.inverse else self.plan.ntt
            if not self._cuda:
                self._results[buf_kernel] = (fn(x), None)
                return
            stream = torch.cuda.current_stream(self.ctx.device)
            stream.wait_event(uploaded)
            x.record_stream(stream)          # allocated on the copy stream
            out = fn(x)
            done = torch.cuda.Event()
            done.record(stream)
            self._results[buf_kernel] = (out, done)

    def wait_result(self, buf_kernel: Optional[int] = None) -> None:
        """ap_done poll analog (ntt_api.rs:89-108).  With a buffer index,
        waits only for that buffer — the other slot keeps computing, which
        is the point of the double-buffered overlap
        (integration_ntt.rs:103-136)."""
        with self._timed("wait_s"):
            targets = (
                self._results if buf_kernel is None else [self._results[buf_kernel]]
            )
            for r in targets:
                if r is not None and r[1] is not None:
                    r[1].synchronize()

    def result(self, buf_kernel: int = 0) -> Optional[bytes]:
        """Drain a buffer back to LE bytes (ntt_api.rs:110-125)."""
        r = self._results[buf_kernel]
        if r is None:
            return None
        self._results[buf_kernel] = None
        self._pop_task()
        out, done = r
        # int32 words on a little-endian host: their bytes are the wire format
        if not self._cuda:
            return out.numpy().tobytes()
        pinned = self._staging(buf_kernel)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(done)
            pinned.copy_(out, non_blocking=True)
            out.record_stream(self._copy_stream)
            drained = torch.cuda.Event()
            drained.record()
        self._pinned_busy[buf_kernel] = drained
        drained.synchronize()
        return pinned.numpy().tobytes()

    def get_api(self) -> dict:
        """Register-dump analog (the NTT HLS control/status surface,
        ntt_hw_code.rs:6-83)."""
        return {
            "buffers": {
                i: ("busy" if self._results[i] is not None
                    else "staged" if self._slots[i] is not None else "empty")
                for i in range(self.NOF_BUFFERS)
            },
            "pending_tasks": self.pending_tasks,
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }


# ========================================================== Poseidon client
@dataclasses.dataclass
class PoseidonInitializeParameters:
    """poseidon_api.rs:20-24 analog.

    The reference loads one opaque CSV instruction stream
    (poseidon_api.rs:205-243); here the leaf (t=12) and node (t=9)
    instances are separate oracle-checkable constant sets, each loadable
    from its own CSV.

    `stream_leaves` > 0 enables the reference's feed-while-hashing
    behavior (integration_poseidon.rs:81-119): every time that many
    complete leaf columns have been fed, their leaf hashes are launched
    at once instead of waiting for start_process — results become
    drainable (drain_stream) before the last element arrives.  TREE_C
    only."""

    tree_height: int
    tree_mode: TreeMode = TreeMode.TREE_C
    instruction_path: Optional[str] = None       # leaf constants CSV
    node_instruction_path: Optional[str] = None  # node constants CSV
    stream_leaves: int = 0                       # leaves per streamed block


@dataclasses.dataclass
class PoseidonResult:
    """poseidon_api.rs:36-71 analog: 32 B hash + ids."""

    hash: bytes
    hash_id: int
    layer_id: int


class PoseidonClient(DriverPrimitive):
    """The 8-ary Poseidon tree client (ingo_hash analog).

    Elements arrive as wire bytes (32 B little-endian each) or as (k, L)
    16-bit limb arrays, any count per call, and are kept as (k, W) word
    arrays.  For a TREE_C build the columns go to the card once as they lie,
    (nleaves*11, W) words, and are permuted there to the lanes-major
    (11, W, nleaves) layout the leaf sponge reads; repeated start_process
    calls reuse them.  Result records are 64 B: the 32 B hash, then
    hash_id in the low 30 bits and layer_id above (poseidon_api.rs:42-71).
    """

    trace_name = "poseidon"

    def __init__(self, field="bls12_381_fr", ctx: Optional[DeviceContext] = None,
                 device: Optional[str] = None):
        super().__init__()
        self.spec: FieldSpec = field if isinstance(field, FieldSpec) else FIELDS[field]
        self.ctx = ctx or DeviceContext(device=device)
        self._param: Optional[PoseidonInitializeParameters] = None
        self._builder: Optional[MerkleTreeBuilder] = None
        # Elements accumulate as whole (k, W) word arrays, not one Python
        # object per element (the reference streams 32 B records by DMA,
        # poseidon_api.rs:117-122).
        self._chunks: list = []
        self._count: int = 0
        self._staged = None          # device-side lanes-major leaf columns
        self._stage_s = 0.0          # seconds of the last staging (copy + permute)
        self._tree: Optional[TreeResult] = None
        # streaming build state (stream_leaves > 0): leaf-hash blocks
        # launched as elements arrive; guarded by a lock so a feeder
        # thread and a drainer thread can share the client the way the
        # reference's rayon pair shares its Arc<Mutex<PoseidonClient>>
        self._lock = threading.RLock()
        self._stream_parts: list = []   # (W, n) Montgomery leaf hashes per block
        self._stream_hashed = 0         # leaves hashed so far
        self._stream_drained = 0        # stream_parts already drained
        self._stream_off = 0            # elements consumed from _chunks[0]

    def loaded_binary_parameters(self) -> ImageParams:
        return ImageParams(
            "poseidon",
            {
                "field": self.spec.name,
                "element_bytes": self.spec.nbytes,
                "leaf_arity": LEAF_ARITY,
                "tree_arity": ARITY,
            },
        )

    def initialize(self, param: PoseidonInitializeParameters) -> None:
        """Reset + constants load + tree params (poseidon_api.rs:96-111)."""
        leaf_params = node_params = None
        if param.instruction_path:
            leaf_params = params_from_csv(self.spec, param.instruction_path, LEAF_ARITY + 1)
        if param.node_instruction_path:
            node_params = params_from_csv(self.spec, param.node_instruction_path, ARITY + 1)
        builder = MerkleTreeBuilder(self.spec, leaf_params=leaf_params,
                                    node_params=node_params, device=self.ctx.device)
        with self._lock:
            self._param = param
            self._builder = builder
            self._chunks.clear()
            self._count = 0
            self._staged = None
            self._tree = None
            self._stream_parts.clear()
            self._stream_hashed = 0
            self._stream_drained = 0
            self._stream_off = 0

    def set_data(self, data) -> None:
        """Stream elements (poseidon_api.rs:117-122); the reference feeds
        11 elements per leaf (integration_poseidon.rs:151-155).  Accepts
        one element or ANY number of elements per call — wire bytes (kept
        as a zero-copy view) or a (k, L) 16-bit limb array."""
        with self._timed("set_data_s"):
            if isinstance(data, (bytes, bytearray, memoryview)):
                raw = np.frombuffer(data, dtype=np.uint8)
                if raw.size % self.spec.nbytes:
                    raise DataError(f"{raw.size} B is not a multiple of the "
                                    f"{self.spec.nbytes} B element size")
                words = raw.view("<u4").reshape(-1, self.spec.nwords)
            else:
                limbs = np.asarray(data)
                if limbs.shape[-1] != self.spec.nlimbs:
                    raise DataError(f"want (k, {self.spec.nlimbs}) limbs, got {limbs.shape}")
                words = np.ascontiguousarray(limbs, dtype="<u2").view("<u4").reshape(
                    -1, self.spec.nwords)
            with self._lock:
                self._chunks.append(words)
                self._count += words.shape[0]
                self._staged = None  # new data invalidates the residency
                self._maybe_stream()

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """(k, W) uint32 host words -> int32 device tensor (the host array,
        possibly a read-only view of the caller's bytes, is never written)."""
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            host = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
        return _device_put(host, self.ctx)

    def _columns_lm(self, words: np.ndarray, nleaf: int) -> torch.Tensor:
        """(nleaf*11, W) host words -> (11, W, nleaf) lanes-major columns on
        the device: one contiguous copy, then a permute there."""
        dev = self._to_device(words)
        return dev.reshape(nleaf, LEAF_ARITY, -1).permute(1, 2, 0).contiguous()

    # ------------------------------------------- streaming (feed-while-hash)
    def _take_elems(self, count: int) -> np.ndarray:
        """Consume `count` elements from the front of the chunk queue."""
        out, need = [], count
        while need:
            head = self._chunks[0]
            avail = head.shape[0] - self._stream_off
            take = min(avail, need)
            out.append(head[self._stream_off : self._stream_off + take])
            self._stream_off += take
            need -= take
            if self._stream_off == head.shape[0]:
                self._chunks.pop(0)
                self._stream_off = 0
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def _dispatch_leaf_block(self, nleaf: int) -> None:
        """Launch the leaf sponge of the next `nleaf` complete columns."""
        cols = self._columns_lm(self._take_elems(nleaf * LEAF_ARITY), nleaf)
        self._stream_parts.append((self._builder.hash_leaves_staged(cols), nleaf))
        self._stream_hashed += nleaf

    def _maybe_stream(self) -> None:
        """Launch leaf hashing for every complete streamed block.  Caller
        holds the lock."""
        p = self._param
        if (p is None or p.stream_leaves <= 0
                or p.tree_mode != TreeMode.TREE_C or self._builder is None):
            return
        nleaves = base_layer_size(p.tree_height)
        while True:
            pending = self._count - self._stream_hashed * LEAF_ARITY
            take = min(p.stream_leaves, nleaves - self._stream_hashed)
            if take <= 0 or pending < take * LEAF_ARITY:
                return
            self._dispatch_leaf_block(take)

    def drain_stream(self) -> list:
        """Drain leaf records hashed so far — BEFORE start_process, like
        the reference's concurrent result loop (poseidon_api.rs:128-145,
        driven from a second thread in integration_poseidon.rs:81-119).
        Returns new PoseidonResult records since the last drain."""
        with self._lock:
            parts = self._stream_parts[self._stream_drained:]
            if not parts:
                return []
            self._stream_drained = len(self._stream_parts)
            offset = self._stream_hashed - sum(n for _, n in parts)
            field = self._builder.field
        recs = []
        for part, _ in parts:
            canon = field.from_mont(part.t().contiguous()).cpu().numpy().view(np.uint32)
            for h in canon:
                recs.append(PoseidonResult(hash=h.tobytes(), hash_id=offset, layer_id=0))
                offset += 1
        return recs

    def get_last_element_sent_to_ring(self) -> int:
        """Element counter (sanity-test contract,
        integration_poseidon.rs:52-56)."""
        return self._count

    def _elements(self, want: int) -> np.ndarray:
        """The first `want` fed elements as one (want, W) array."""
        arr = self._chunks[0] if len(self._chunks) == 1 else np.concatenate(self._chunks)
        return arr[:want]

    def start_process(self, param=None) -> None:
        with self._lock:
            if self._param is None or self._builder is None:
                raise NotReady("initialize() first")
            h, mode = self._param.tree_height, self._param.tree_mode
            nleaves = base_layer_size(h)
            want = nleaves * (LEAF_ARITY if mode == TreeMode.TREE_C else 1)
            if self._count < want:
                raise NotReady(f"need {want} elements for height {h}, have {self._count}")
            with self._timed("start_s"):
                label = self._push_task()
                if self._param.stream_leaves > 0 and mode == TreeMode.TREE_C:
                    # streaming build: leaves were hashed as they arrived;
                    # hash the tail block and close the tree over the
                    # assembled leaf layer
                    remaining = nleaves - self._stream_hashed
                    if remaining:
                        self._dispatch_leaf_block(remaining)
                    parts = [part for part, _ in self._stream_parts]
                    leaf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
                    self._tree = self._builder.close_staged(leaf, h)
                elif mode == TreeMode.TREE_C:
                    # device residency: stage the lanes-major column layout
                    # ONCE (HBM-points analog, msm_api.rs:144-153) — repeated
                    # start_process calls re-run the engine without re-upload
                    if self._staged is None:
                        t0 = time.perf_counter()
                        self._staged = self._columns_lm(self._elements(want), nleaves)
                        self._sync()
                        self._stage_s = time.perf_counter() - t0
                    self._tree = self._builder.build_staged(self._staged, h)
                else:
                    leaves = self._to_device(self._elements(want))
                    self._tree = self._builder.build(leaves, h, TreeMode.TREE_D)
                self._tree.task_label = label

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def wait_result(self) -> None:
        """Block until the tree build completes (result-drain poll analog,
        poseidon_api.rs:128-145: the launches are in flight on the CUDA
        stream)."""
        with self._timed("wait_s"):
            if self._tree is not None:
                self._tree.block_until_ready()

    def _drain(self):
        """[(layer_id, (count, W) uint32 canonical words)], leaf layer
        first, and pops the task; None before a build."""
        if self._tree is None:
            return None
        out = list(enumerate(self._tree.host_layers()))
        self._pop_task()
        return out

    def result_arrays(self):
        """Array-speed drain: [(layer_id, (count, L) uint32 canonical
        16-bit limbs)] per tree layer, leaf layer first — the reference's
        streaming drain (poseidon_api.rs:128-145) at client scale, no
        per-node Python objects."""
        with self._result_span():
            layers = self._drain()
            if layers is None:
                return None
            return [(lid, w.view("<u2").astype(np.uint32)) for lid, w in layers]

    def _result_span(self):
        return span("blaze.poseidon.result",
                    None if self._tree is None else self._tree.task_label)

    def result_raw(self) -> Optional[bytes]:
        """Wire-format drain: the reference's 64 B record stream — 32 B
        LE hash + packed meta with hash_id in the low 30 bits and
        layer_id above (PoseidonResult::parse_poseidon_hash_results,
        poseidon_api.rs:42-71) — built with array ops."""
        with self._result_span():
            layers = self._drain()
            if layers is None:
                return None
            nbytes = self.spec.nbytes
            parts = []
            for lid, arr in layers:
                n = arr.shape[0]
                rec = np.zeros((n, 64), np.uint8)
                rec[:, :nbytes] = arr.view(np.uint8).reshape(n, nbytes)
                meta = ((np.arange(n, dtype=np.uint64) & np.uint64(0x3FFFFFFF))
                        | (np.uint64(lid) << np.uint64(30)))
                rec[:, 32:40] = meta.astype("<u8")[:, None].view(np.uint8)
                parts.append(rec.tobytes())
            return b"".join(parts)

    def result(self, expected_count: Optional[int] = None):
        """Drain records (poseidon_api.rs:128-145)."""
        layers = self._drain()
        if layers is None:
            return None
        recs = [PoseidonResult(hash=h.tobytes(), hash_id=hid, layer_id=lid)
                for lid, arr in layers for hid, h in enumerate(arr)]
        if expected_count is not None and len(recs) != expected_count:
            raise NotReady(f"expected {expected_count} nodes, got {len(recs)}")
        return recs

    @property
    def root(self):
        """The root's canonical (W,) uint32 words, or None before a build."""
        return None if self._tree is None else self._tree.root

    # ---------------------------------------------- status getters (parity)
    def get_num_of_pending_results(self) -> int:
        """Undrained node count (poseidon_api.rs:156 analog).  During a
        streaming build (before start_process) this counts leaf hashes
        launched but not yet drained by drain_stream."""
        if self._tree is None:
            with self._lock:
                return sum(n for _, n in self._stream_parts[self._stream_drained:])
        return len(self._tree)

    def get_last_node_id_in_ring(self) -> int:
        """Ring last-id analog (poseidon_api.rs:149-203): nodes produced
        by the engine so far — streamed leaf hashes count as soon as
        their block is launched."""
        if self._tree is None:
            return self._stream_hashed
        return len(self._tree)

    def get_api(self) -> dict:
        """Register-dump analog (log_api_values,
        poseidon_api.rs:245-253 + hash_hw_code.rs:7-26)."""
        return {
            "elements_staged": self._count,
            "pending_results": self.get_num_of_pending_results(),
            "device_residency": self._staged is not None,
            "stage_s": self._stage_s,
            "streamed_leaves": self._stream_hashed,
            "pending_tasks": self.pending_tasks,
            "timings": dataclasses.asdict(self._timings),
            "health": dataclasses.asdict(self.ctx.health()),
        }
