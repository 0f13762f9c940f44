"""The MSM and NTT clients — the ingo_msm and ingo_ntt module analogs.

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
"""
from __future__ import annotations

import collections
import dataclasses
import logging
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
from .primitive import DriverPrimitive, ImageParams, timed
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
    points: Optional[object] = None  # bytes or (N, 2, W) canonical uint32 words
    params: Optional[MSMParams] = None


@dataclasses.dataclass
class MSMResult:
    """msm_api.rs result analog: z||y||x LE bytes + task label."""

    result: bytes
    label: int


class MSMClient(DriverPrimitive):
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
        n = scal.shape[0]
        st = _as_i32(scal)
        bits = None
        k = self.init.precompute_factor
        if k > 1:
            st, bits = split_scalars(st, k, spec.fr.bits)
        return n, _device_put(scalars_to_resident(st), self.ctx), bits

    def _stage_points(self, points, n: int) -> torch.Tensor:
        """Wire bytes or words for n bases -> resident device points."""
        spec = self.curve.spec
        k = self.init.precompute_factor
        if isinstance(points, (bytes, bytearray, memoryview)):
            pts = decode_affine_points(points, spec)
        else:
            pts = np.asarray(points, dtype=np.uint32)
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

    def set_data(self, input: MSMInput) -> None:
        """Three modes (msm_api.rs:122-220):
        1. points + scalars (DMA);
        2. points cached under a key + scalars (HBM load);
        3. scalars only, points reused from cache (HBM reuse).

        With an OPEN STREAMING TASK (start_process called first — the
        reference's order, msm_api.rs:156-217) each call stages one chunk
        and computes its per-window partials at once, so the full operand
        set never has to be resident."""
        if self._stream is not None:
            return self._set_data_stream(input)
        with timed(self._timings, "set_data_s"):
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
                if key is None or key not in self._hbm_cache:
                    raise NotReady(
                        "scalars-only set_data needs points cached under "
                        f"hbm_point_addr (key={key!r})"
                    )
                self._points = self._hbm_cache[key]  # mode 3: reuse

    def _set_data_stream(self, input: MSMInput) -> None:
        """One streamed chunk: stage + compute its window partials."""
        with timed(self._timings, "set_data_s"):
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
                key = params.hbm_point_addr
                if key is None or key not in self._hbm_cache:
                    raise NotReady(
                        "streamed scalars-only chunks need points cached "
                        f"under hbm_point_addr (key={key!r})"
                    )
                cache = self._hbm_cache[key]
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

            part = self.engine.msm_partial(pdev, sdev, st["c"], scalar_bits)
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
        if self._stream is not None:
            raise NotReady(
                f"streaming task open ({self._stream['consumed']} of "
                f"{self._params.nof_elements} elements fed)"
            )
        if self._points is None or self._scalars is None:
            if self._params is None:
                raise NotReady("set_data() first")
            with timed(self._timings, "start_s"):
                n = self._params.nof_elements
                c = min(self.engine.config.window_bits, default_window_bits(n))
                self._stream = {
                    "label": self._push_task(),
                    "wsums": None,
                    "consumed": 0,
                    "c": c,
                }
            return
        with timed(self._timings, "start_s"):
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
        if self._stream is not None:
            st = self._stream
            n = self._params.nof_elements
            if st["consumed"] < n:
                raise NotReady(f"streamed {st['consumed']} of {n} elements")
            with timed(self._timings, "wait_s"):
                out = self.engine.finalize(st["wsums"], st["c"])
                self._inflight.append((st["label"], out))
                self._stream = None
                hard_sync(out)
            return
        if not self._inflight:
            return
        with timed(self._timings, "wait_s"):
            hard_sync(self._inflight[0][1])

    def result(self, param=None) -> Optional[MSMResult]:
        """Pop the oldest completed task (POP_RESULT, msm_api.rs:240-274)."""
        if self._stream is not None:
            self.wait_result()      # close the streaming task (fold + sync)
        if not self._inflight:
            return None
        self.wait_result()
        label, out = self._inflight.popleft()
        proj = self.curve.fq.from_mont(out)            # (3, W) canonical
        raw = encode_projective_result(
            proj.cpu().numpy().view(np.uint32), self.curve.spec
        )
        popped = self._pop_task()
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
        """Explicit point residency (msm_api.rs:299-311)."""
        spec = self.curve.spec
        if isinstance(points, (bytes, bytearray, memoryview)):
            points = decode_affine_points(points, spec)
        dev = _device_put(_as_i32(np.asarray(points, np.uint32)), self.ctx)
        self._hbm_cache[key] = points_to_resident(self.curve, dev)

    def get_data_from_hbm(self, key: str) -> np.ndarray:
        """Read back cached points, canonical words (msm_api.rs:313-322)."""
        dev = points_from_resident(self.curve, self._hbm_cache[key])
        return self.curve.fq.from_mont(dev).cpu().numpy().view(np.uint32)

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

    data: object                   # bytes or (n, W) canonical uint32 words
    buf_host: int = 0              # double-buffer slot (ntt_data.rs:54-56)


class NTTClient(DriverPrimitive):
    """Double-buffered NTT: two device slots, start/wait per slot — the
    pipelined flow of integration_ntt.rs:103-136.

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
        """Wire bytes (a zero-copy view) or words -> (n, W) int32 words."""
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
            words = np.asarray(data, dtype=np.uint32)
            if words.ndim != 2 or words.shape[1] != W:
                raise DataError(f"want (n, {W}) words, got {words.shape}")
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
        with timed(self._timings, "set_data_s"):
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
        with timed(self._timings, "start_s"):
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
        with timed(self._timings, "wait_s"):
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
