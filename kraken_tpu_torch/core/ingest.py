"""Pipelined ingest plane: blob windows -> card hash, stages overlapped.

The port of ``kraken_tpu.core.ingest``. A blob streams through staging
windows:

    read -> pack -> transfer -> hash        (per window)

with ``windows_in_flight`` windows overlapped: while window k hashes on
the card, window k+1 is being read into its own staging buffer. Staging
buffers are leased from a :class:`~kraken_tpu_torch.utils.bufpool.BufferPool`
and reused across windows; the read lands bytes directly in the buffer
the pack/transfer consumes.

Stage semantics per window:

- **read**: filling the staging buffer (``readinto`` on the re-generate
  path of ``origin/metainfogen.py``).
- **pack**: producing the packed word-major layout. ``pack_mode: host``
  has no pack stage: the hasher's own ``hash_pieces`` reads natural
  bytes. ``native`` runs the C host packer (``kraken_tpu_torch.native``)
  over ``pack_workers`` HashPool threads; ``device`` relays out on the
  card (``ops.sha256_cuda.pack_tiles_device``), billed the kernel's time
  from CUDA events.
- **transfer**: the host-to-device copy of the window (for a staged
  window, its copy into pinned memory and the copies' enqueue: the
  readback in **hash** waits for the copies themselves).
- **hash**: the kernel launch + digest readback (the readback is the
  window's sync point: every copy out of the staging lease has finished
  before the lease returns to the pool), or the hashlib pass after an
  injected device fault (the ``origin.ingest.device_fail`` drill, or any
  ``ingest.window.*`` failpoint on the device path). A real device error
  fails the window and the session; it never reroutes to the CPU.

The packed path (``native``/``device``) needs a window of whole 1024-piece
tiles with ``piece_length % 64 == 0`` and a card hasher, ``cuda``
(``ops.sha256.TorchPieceHasher``) or ``cuda-sharded``
(``parallel.hashplane.ShardedPieceHasher``), whose ``device`` it runs on:
the card or, for tests, the CPU through the kernels' plain versions. A
uniform window of a hasher with the staged-window protocol
(``stage_window`` / ``hash_staged_window``, the sharded hasher's) is
placed on its mesh and hashed there, billed to transfer and hash apart;
other windows take the hasher's own ``hash_pieces``, bit-identically.

Every window observes ``ingest_stage_seconds{stage}``. The hash plane's
``ingest`` path (``utils/trace.py``) bills the reader's wait for a free
window slot (``slot``), a window's wait for its worker (``pool``) and,
inside the hasher, its staging, submit and readback. Digests are
bit-identical to the serial oracle by construction: pipelining reorders
WHEN a piece is hashed, never piece boundaries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch import native
from kraken_tpu_torch.core.hasher import (
    DIGEST_SIZE,
    HashPool,
    PieceHasher,
    record_hash_metrics,
)
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.ops.sha256 import _digest_bytes
from kraken_tpu_torch.ops.sha256_ref import N_TILE, packed_nb
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.bufpool import BufferPool
from kraken_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger("kraken.ingest")

STAGES = ("read", "pack", "transfer", "hash")

PACK_MODES = ("host", "native", "device")

# Stage walls span ~100 us (a small window) to ~10 s (a multi-GiB window
# on a cold page cache): wider-than-default log-spaced buckets.
_STAGE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def record_stage(stage: str, seconds: float) -> None:
    """One window's (or an upload commit's) wall for one pipeline stage."""
    REGISTRY.histogram(
        "ingest_stage_seconds",
        "Per-window wall of each ingest pipeline stage",
        buckets=_STAGE_BUCKETS,
    ).observe(seconds, stage=stage)


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """The ingest knobs (the origin's ``ingest:`` section). ``resume`` and
    ``serve_while_ingest`` are read by the ``OriginServer`` whose
    ``ingest_pipeline`` this is, unless its caller pins them
    (``OriginServer(ingest_resume=, serve_while_ingest=)``); the pipeline
    itself ignores them."""

    # Bytes per pipeline window (floored to whole pieces at run time; a
    # window always holds >= 1 piece; with a packed mode, floored to whole
    # 1024-piece tiles once it holds one). Peak staging is roughly
    # window_bytes * windows_in_flight.
    window_bytes: int = 64 * 1024 * 1024
    # Windows concurrently in flight (read overlapping pack/transfer/
    # hash). 2 = double buffering; 1 degenerates to the serial path.
    windows_in_flight: int = 2
    # HashPool workers for the ``pack: native`` cooperative pack (the C
    # packer's 16-piece groups split across them, GIL-free). 0 = pack on
    # the window worker itself.
    pack_workers: int = 1
    # host   -- natural layout: the hasher's own hash_pieces (the natural
    #           kernel of csrc/sha256.cu).
    # native -- host pack to the packed layout, then the packed kernel;
    #           needs spare feeder cores.
    # device -- natural bytes to the card, relayout kernel, packed kernel.
    # Modes other than host need tile-quantum windows (1024 pieces) and
    # a card hasher (cuda, cuda-sharded); other windows take host-mode handling,
    # bit-identically.
    pack_mode: str = "host"
    # Resumable upload sessions: journal per-upload durable progress to an
    # ``upload/<uid>.session`` sidecar so a crashed origin, or one whose
    # PATCH failed mid-stream, re-adopts the session and the client
    # resumes from the journaled offset instead of from zero. On (one
    # small sidecar write per flush batch).
    resume: bool = True
    # Publish metainfo and seed the blob from its upload spool as soon as
    # every piece is hashed -- before the commit rename -- so agents fan
    # out behind the upload front. Off.
    serve_while_ingest: bool = False

    def __post_init__(self):
        if self.window_bytes < 1 << 20:
            raise ValueError(
                f"ingest.window_bytes must be >= 1 MiB: {self.window_bytes}"
            )
        if self.windows_in_flight < 1:
            raise ValueError(
                "ingest.windows_in_flight must be >= 1: "
                f"{self.windows_in_flight}"
            )
        if self.pack_workers < 0:
            raise ValueError(
                f"ingest.pack_workers must be >= 0: {self.pack_workers}"
            )
        if self.pack_mode not in PACK_MODES:
            raise ValueError(
                f"ingest.pack_mode must be one of {PACK_MODES}: "
                f"{self.pack_mode!r}"
            )

    @classmethod
    def from_dict(cls, doc: dict | None) -> "IngestConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown ingest config keys: {sorted(unknown)}")
        return cls(**doc)


class IngestPipeline:
    """Window-stream executor over one PieceHasher.

    Thread-safe; one pipeline per origin process. :meth:`apply` swaps the
    config live -- in-flight sessions keep their birth config, new
    sessions see the new knobs.
    """

    def __init__(self, hasher: PieceHasher, config: IngestConfig | None = None):
        self.hasher = hasher
        self.config = config or IngestConfig()
        self._lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._executor_width = 0
        self._pack_pool: Optional[HashPool] = None
        self._pack_pool_width = 0
        # Staging buffers: retained budget sized to the steady state
        # (windows_in_flight leases cycling) so the pool serves every
        # window after the first lap without allocator traffic.
        self._bufpool = BufferPool(
            budget_bytes=self.config.window_bytes
            * (self.config.windows_in_flight + 1),
            name="ingest",
        )

    def apply(self, config: IngestConfig) -> None:
        """Live config swap. Cheap when nothing changed."""
        with self._lock:
            old, self.config = self.config, config
            if old == config:
                return
            self._bufpool.set_budget(
                config.window_bytes * (config.windows_in_flight + 1)
            )
            if self._executor is not None and (
                self._executor_width != config.windows_in_flight
            ):
                # The old executor drains its queued windows and exits;
                # new sessions get a fresh one at the new width.
                self._executor.shutdown(wait=False)
                self._executor = None

    def _get_executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor_width = self.config.windows_in_flight
                self._executor = ThreadPoolExecutor(
                    self._executor_width, thread_name_prefix="ingest"
                )
            return self._executor

    def _get_pack_pool(self) -> Optional[HashPool]:
        with self._lock:
            want = self.config.pack_workers
            if want < 1:
                return None
            if self._pack_pool is None or self._pack_pool_width != want:
                self._pack_pool = HashPool(want, name="pack")
                self._pack_pool_width = want
            return self._pack_pool

    def session(self, piece_length: int) -> "IngestSession":
        if piece_length <= 0:
            raise ValueError(f"piece_length must be positive: {piece_length}")
        return IngestSession(self, piece_length)


class IngestSession:
    """One blob's window stream through the pipeline.

    Caller protocol (any ONE thread):

        ses = pipeline.session(piece_length)
        while bytes remain:
            buf = ses.begin_window()     # memoryview to fill
            n = fill(buf)                # readinto / chunk copies
            ses.submit(n)                # queues pack/transfer/hash
        digests = ses.finish()           # [N, 32] uint8, piece order

    ``submit`` blocks once ``windows_in_flight`` windows are queued or
    running -- that backpressure IS the double-buffer bound. Only the
    LAST submitted window may be short or ragged.
    """

    def __init__(self, pipeline: IngestPipeline, piece_length: int):
        cfg = pipeline.config
        self.pipeline = pipeline
        self.piece_length = piece_length
        pieces = max(1, cfg.window_bytes // piece_length)
        if cfg.pack_mode != "host" and pieces >= N_TILE:
            # The packed layout moves in 1024-piece tiles; a tile-quantum
            # window lets every full window take the packed path.
            pieces -= pieces % N_TILE
        self.window_bytes = pieces * piece_length
        self._cfg = cfg
        self._sem = threading.Semaphore(cfg.windows_in_flight)
        self._futs: list[Future] = []
        self._lease = None
        self._read_t0 = 0.0
        self._t0: Optional[float] = None
        # Sticky device->host degradation flag: set by the first window
        # whose device path takes an injected fault; later windows route
        # straight to the host pass. Benign cross-thread bool.
        self._fell_back = False
        self.stage_seconds: dict[str, float] = dict.fromkeys(STAGES, 0.0)
        # The reader's waits for a free window slot (not a pipeline stage).
        self.slot_seconds = 0.0
        self.windows = 0
        self.wall_seconds = 0.0

    # -- caller side -----------------------------------------------------

    def begin_window(self) -> memoryview:
        """Lease the next staging buffer. The read wall for the window is
        measured from here to :meth:`submit`."""
        if self._lease is not None:
            raise RuntimeError("previous window was never submitted")
        if failpoints.fire("ingest.window.read"):
            # Staging-read fault: fired BEFORE the semaphore/lease so
            # nothing needs returning; the caller's abort() path is what
            # the site exists to exercise.
            raise failpoints.FailpointError("ingest.window.read")
        # Blocks while windows_in_flight windows are queued/running: the
        # NEXT read must not race ahead of the staging budget.
        with trace.stage("slot", "ingest") as slot:
            self._sem.acquire()
        self.slot_seconds += slot.seconds
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._lease = self.pipeline._bufpool.lease(self.window_bytes)
        self._read_t0 = time.perf_counter()
        return self._lease.view[: self.window_bytes]

    def submit(self, nbytes: int) -> None:
        """Queue the filled prefix of the current staging buffer."""
        if self._lease is None:
            raise RuntimeError("submit without begin_window")
        if not 0 <= nbytes <= self.window_bytes:
            raise ValueError(f"submit: {nbytes} outside window")
        lease, self._lease = self._lease, None
        now = time.perf_counter()
        read_s = now - self._read_t0
        self.stage_seconds["read"] += read_s
        record_stage("read", read_s)
        self.windows += 1
        if nbytes == 0:
            lease.release()
            self._sem.release()
            return
        fut = self.pipeline._get_executor().submit(
            self._process, lease, nbytes, now
        )
        self._futs.append(fut)

    def finish(self) -> np.ndarray:
        """Wait for every window; concatenated digests in piece order."""
        if self._lease is not None:  # begin_window with no submit
            self._lease.release()
            self._lease = None
            self._sem.release()
        parts = [f.result() for f in self._futs]
        self.wall_seconds = (
            time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        )
        REGISTRY.counter(
            "ingest_windows_total",
            "Windows processed by the pipelined ingest plane",
        ).inc(self.windows, hasher=self.pipeline.hasher.name)
        if self.wall_seconds > 0:
            REGISTRY.gauge(
                "ingest_last_overlap_ratio",
                "sum(stage walls) / wall of the last ingest session "
                "(>1 = stages overlapped)",
            ).set(self.overlap_ratio(), hasher=self.pipeline.hasher.name)
        if not parts:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def abort(self) -> None:
        """Stop trusting this session: wait out in-flight windows (their
        leases must return to the pool) and drop the results. The
        un-submitted window's lease is released here; submitted windows
        release theirs in ``_process``'s finally -- joined below."""
        hit = failpoints.fire("ingest.abort")
        if hit and hit.delay_s:
            # Chaos: stretch the abort window so teardown races become
            # reachable.
            time.sleep(hit.delay_s)
        if self._lease is not None:
            self._lease.release()
            self._lease = None
            self._sem.release()
        for f in self._futs:
            try:
                f.result()
            except Exception:  # kt-lint: disable=bare-except  # aborting: window results AND their failures are discarded by contract -- the caller falls back to the verifying re-read pass
                pass
        self._futs = []

    def completed_digest_prefix(self) -> np.ndarray:
        """Digests of the in-order prefix of windows already hashed --
        non-blocking (stops at the first pending window)."""
        out = []
        for f in self._futs:
            if not f.done() or f.exception() is not None:
                break
            out.append(f.result())
        if not out:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        return np.concatenate(out) if len(out) > 1 else out[0]

    def digest_prefix(self, n_pieces: int) -> np.ndarray:
        """First ``n_pieces`` digests, blocking on the windows that hold
        them. Window faults propagate."""
        out, got = [], 0
        for f in self._futs:
            if got >= n_pieces:
                break
            arr = f.result()
            out.append(arr)
            got += arr.shape[0]
        if not out:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        cat = np.concatenate(out) if len(out) > 1 else out[0]
        return cat[:n_pieces]

    def overlap_ratio(self) -> float:
        """sum-of-stage-walls / session wall. 1.0 = fully serial; toward
        ``windows_in_flight`` = stages genuinely overlapped."""
        if self.wall_seconds <= 0:
            return 1.0
        return sum(self.stage_seconds.values()) / self.wall_seconds

    # -- worker side -----------------------------------------------------

    def _bill(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] += seconds
        record_stage(stage, seconds)

    def _process(self, lease, nbytes: int, submitted: float) -> np.ndarray:
        trace.bill("pool", time.perf_counter() - submitted, path="ingest")
        try:
            with trace.plane("ingest"):
                return self._window(lease.view[:nbytes])
        finally:
            lease.release()
            self._sem.release()

    def _window(self, view) -> np.ndarray:
        """One window: the hasher's path, or the host pass after a fault."""
        plen = self.piece_length
        if self._fell_back:
            # A previous window already tripped the device fallback:
            # the rest of the stream stays on the host path (a card
            # that faulted once is not re-trusted mid-blob).
            return self._host_window(view, plen)
        try:
            if failpoints.fire("origin.ingest.device_fail"):
                raise failpoints.FailpointError(
                    "origin.ingest.device_fail"
                )
            return self._hasher_window(view, plen)
        except failpoints.FailpointError as e:
            # The fallback drill: an injected device-path fault
            # reroutes this window AND the stream remainder to the
            # host hashlib pass -- bit-identical by construction (same
            # piece boundaries, same SHA-256). Any other error (a
            # kernel that did not build or launch) propagates: the
            # session fails and the caller sees it, rather than the
            # card path quietly running on the CPU.
            self._fell_back = True
            REGISTRY.counter(
                "ingest_fallbacks_total",
                "Ingest windows rerouted to the host hash path after"
                " an injected device-path fault (one increment per"
                " fallback event, not per rerouted window)",
            ).inc(reason="failpoint")
            _log.warning(
                "ingest window hash failed on %s (%s); host hash "
                "path takes the stream remainder",
                self.pipeline.hasher.name, e,
            )
            return self._host_window(view, plen)

    def _hasher_window(self, view, plen: int) -> np.ndarray:
        """The configured hasher's path for one window: the packed kernels,
        the hasher's staged windows, or its own batch call."""
        m, ragged = divmod(len(view), plen)
        hasher = self.pipeline.hasher
        if m > 0 and ragged == 0 and plen % 64 == 0:
            arr = np.frombuffer(view, dtype=np.uint8).reshape(m, plen)
            if (
                self._cfg.pack_mode != "host"
                and m % N_TILE == 0
                and hasher.name.startswith("cuda")
            ):
                return self._packed_window(arr, plen)
            if hasattr(hasher, "stage_window"):
                if failpoints.fire("ingest.window.transfer"):
                    raise failpoints.FailpointError("ingest.window.transfer")
                t0 = time.perf_counter()
                handle = hasher.stage_window(arr, plen)
                self._bill("transfer", time.perf_counter() - t0)
                if failpoints.fire("ingest.window.hash"):
                    raise failpoints.FailpointError("ingest.window.hash")
                t0 = time.perf_counter()
                out = hasher.hash_staged_window(handle)
                self._bill("hash", time.perf_counter() - t0)
                return out
        # A cpu hasher, a ragged or short final window, a hasher without
        # the packed kernels or the staged protocol: one batch call,
        # billed to hash.
        if failpoints.fire("ingest.window.hash"):
            raise failpoints.FailpointError("ingest.window.hash")
        t0 = time.perf_counter()
        out = hasher.hash_pieces(view, plen)
        self._bill("hash", time.perf_counter() - t0)
        return out

    def _host_window(self, view, plen: int) -> np.ndarray:
        """Inline hashlib piece pass -- the degradation target. No device,
        no pool, no shared state: cannot fail the way the primary path
        just did."""
        nbytes = len(view)
        n = -(-nbytes // plen)
        out = np.empty((n, DIGEST_SIZE), dtype=np.uint8)
        t0 = time.perf_counter()
        for i in range(n):
            piece = view[i * plen : (i + 1) * plen]
            out[i] = np.frombuffer(hashlib.sha256(piece).digest(), dtype=np.uint8)
        self._bill("hash", time.perf_counter() - t0)
        return out

    def _packed_window(self, arr: np.ndarray, plen: int) -> np.ndarray:
        """``pack: native|device`` window: an explicit relayout into the
        packed layout, then the packed hash kernel."""
        if failpoints.fire("ingest.window.pack"):
            raise failpoints.FailpointError("ingest.window.pack")
        device = self.pipeline.hasher.device
        nb = plen // 64
        pack_marks = None
        if self._cfg.pack_mode == "native":
            t0 = time.perf_counter()
            packed = native.pack_tiles_pooled(
                arr, packed_nb(nb), self.pipeline._get_pack_pool()
            )
            self._bill("pack", time.perf_counter() - t0)
            if failpoints.fire("ingest.window.transfer"):
                raise failpoints.FailpointError("ingest.window.transfer")
            t0 = time.perf_counter()
            # uint32 words cross as their int32 bit patterns.
            x = torch.from_numpy(packed.view(np.int32)).view(
                -1, packed_nb(nb), 16, 8, 128
            ).to(device)
            self._bill("transfer", time.perf_counter() - t0)
        else:  # device: natural bytes to the card, relayout there
            if failpoints.fire("ingest.window.transfer"):
                raise failpoints.FailpointError("ingest.window.transfer")
            t0 = time.perf_counter()
            natural = torch.from_numpy(arr).to(device)
            self._bill("transfer", time.perf_counter() - t0)
            if device.type == "cuda":
                # The kernel's own time, from events on the stream: a host
                # sync here would also wait out the other window's queued
                # hash and stall this worker.
                pack_marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                pack_marks[0].record()
                x = sha256_cuda.pack_tiles_device(natural, nb)
                pack_marks[1].record()
            else:
                t0 = time.perf_counter()
                x = sha256_cuda.pack_tiles_device(natural, nb)
                self._bill("pack", time.perf_counter() - t0)
            del natural
        if failpoints.fire("ingest.window.hash"):
            raise failpoints.FailpointError("ingest.window.hash")
        t0 = time.perf_counter()
        out = _digest_bytes(sha256_cuda.sha256_packed_tiles(x, nb))
        hash_s = time.perf_counter() - t0
        if pack_marks is not None:
            # The readback waited for the pack too: bill it to pack alone.
            pack_s = pack_marks[0].elapsed_time(pack_marks[1]) / 1e3
            self._bill("pack", pack_s)
            hash_s = max(0.0, hash_s - pack_s)
        self._bill("hash", hash_s)
        record_hash_metrics(
            self.pipeline.hasher.name, arr.size, arr.shape[0], hash_s
        )
        return out
