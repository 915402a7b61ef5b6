"""Continuous profiling plane: the always-on sampling profiler.

The port's part of ``kraken_tpu.utils.profiler``, what the dispatcher
reads: :class:`SamplingProfiler` -- a background daemon thread walking
``sys._current_frames()`` at ``profiling.hz``, folding each thread's
stack (``root;...;leaf``) and tagging it with a data-plane label (pump /
verify / pwrite / dispatch / store / pack / ingest / idle / other).
:meth:`SamplingProfiler.plane_cumulative` is the monotonic per-plane
count the dispatcher baselines a pull's plane split against.

The sample ring, its flamegraph and postmortem dumps, the samples
shipped home by forked workers, the loop-lag monitor
(``LoopLagMonitor``) and the heap profiler (``HeapProfiler``) wait for
the debug slice.

Overhead discipline: the shipped rate is LOW, and a sample is one
``sys._current_frames()`` walk plus a few dict increments off the event
loop entirely.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import sys
import threading
from typing import Iterable, Optional

_log = logging.getLogger("kraken.profiler")

# -- plane classification ---------------------------------------------------

# Data-plane attribution rules, matched leaf-first against each folded
# frame (``file.py:func``): the first hit names the plane -- is the leech
# pump (recv framing) or the verify hash or the pwrite the single-core
# bound? Order matters: storage.py hosts both verify dispatch and the
# pwrite, so the function-qualified rules come before the generic ones.
_PLANE_RULES: tuple[tuple[str, str], ...] = (
    ("storage.py:_write_at", "pwrite"),
    ("storage.py:write_piece", "pwrite"),
    ("castore.py:", "store"),
    ("hasher.py:", "verify"),
    ("sha256", "verify"),
    ("_hashlib", "verify"),
    ("storage.py:_hash_off_loop", "verify"),
    ("storage.py:verify", "verify"),
    ("wire.py:", "pump"),
    ("conn.py:", "pump"),
    ("bufpool.py:", "pump"),
    # asyncio's selector transport read callback: the kernel->userspace
    # recv copy + StreamReader feed -- the raw ingress half of the pump.
    ("selector_events.py:_read_ready", "pump"),
    ("dispatch.py:", "dispatch"),
    ("scheduler.py:", "dispatch"),
    # Pipelined ingest plane (core/ingest.py): pack-worker threads show
    # as "pack" (the host relayout feeding the packed kernel -- the
    # function-qualified rule catches both native/__init__.py entries and
    # the C call's Python frame), window workers as "ingest".
    ("__init__.py:pack_tiles", "pack"),
    ("ingest.py:", "ingest"),
)

# A thread parked here is idle, not working: the event loop in its
# selector, a worker thread waiting for a task, the sampler's own wait.
_IDLE_MARKS = (
    "selectors.py:select",
    "threading.py:wait",
    "threading.py:_wait_for_tstate_lock",
    "queue.py:get",
    "socket.py:accept",
    "thread.py:_worker",  # an executor thread parked on its work queue
)


def classify_plane(frames: Iterable[str]) -> str:
    """Plane tag for one folded stack (frames leaf-last). The leaf
    decides idleness; the deepest rule hit decides the plane."""
    frames = list(frames)
    if frames:
        leaf = frames[-1]
        for mark in _IDLE_MARKS:
            if mark in leaf:
                return "idle"
    for frame in reversed(frames):
        for needle, plane in _PLANE_RULES:
            if needle in frame:
                return plane
    return "other"


def fold_stack(frame, max_depth: int = 64) -> list[str]:
    """One thread's live stack as ``file.py:func`` frames, root-first."""
    out: list[str] = []
    depth = max_depth
    while frame is not None and depth > 0:
        code = frame.f_code
        out.append(
            f"{os.path.basename(code.co_filename)}:{code.co_name}"
        )
        frame = frame.f_back
        depth -= 1
    out.reverse()
    return out


# -- config -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """The part of the YAML ``profiling:`` section that the sampler
    reads. The loop-lag, heap and dump knobs configure parts that wait
    for the debug slice, so they are no keys here."""

    # Master switch: off = no sampler thread.
    enabled: bool = True
    # Sampling frequency. Shipped LOW: a sample walks every thread.
    hz: float = 29.0
    # Frames kept per folded stack (leaf-most win).
    max_stack_depth: int = 24

    @classmethod
    def from_dict(cls, doc: dict | None) -> "ProfilerConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown profiling config keys: {sorted(unknown)}"
            )
        cfg = cls(**doc)
        if not 0.0 < cfg.hz <= 250.0:
            raise ValueError(
                f"profiling.hz must be in (0, 250], got {cfg.hz}"
            )
        return cfg


# -- the sampler ------------------------------------------------------------

class SamplingProfiler:
    """One per process (like the metric REGISTRY and the TRACER). A node
    sets its config and calls :meth:`start`; :meth:`plane_cumulative` is
    what the dispatcher reads."""

    def __init__(self, config: ProfilerConfig | None = None):
        self.config = config or ProfilerConfig()
        self._lock = threading.Lock()
        # Monotonic per-plane sample counts, never trimmed: delta
        # consumers (the per-pull plane_split in dispatch.py) baseline
        # against this. O(planes) memory.
        self._plane_cum: collections.Counter[str] = collections.Counter()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._c_samples = None  # lazy: registering at import would force
        # the metric on processes that never profile

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running or not self.config.enabled:
            return
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kraken-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        if t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None

    # -- the sampling thread -----------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.config.hz
        while not self._stop_evt.wait(period):
            try:
                self._sample_once()
            except Exception:  # the profiler must never take the node down
                _log.warning("profiler sample failed", exc_info=True)

    def _sample_once(self) -> None:
        own = threading.get_ident()
        frames = sys._current_frames()
        planes: list[str] = []
        # Drop each frame reference the moment it is folded (and the
        # dict before touching the lock): a held frame keeps a
        # just-returned function's locals alive, and code that closes
        # exact-lifetime resources (mmaps, exported memoryviews) right
        # after a hot call would see BufferError for every beat we
        # extend them.
        for tid in list(frames):
            frame = frames.pop(tid)
            if tid == own:
                continue
            parts = fold_stack(frame, self.config.max_stack_depth)
            del frame
            planes.append(classify_plane(parts))
        del frames
        with self._lock:
            self._plane_cum.update(planes)
        if planes:
            if self._c_samples is None:
                from kraken_tpu_torch.utils.metrics import REGISTRY

                self._c_samples = REGISTRY.counter(
                    "profiler_samples_total",
                    "Thread-stack samples taken by the sampling profiler",
                )
            self._c_samples.inc(len(planes))

    # -- reading -----------------------------------------------------------

    def plane_cumulative(self) -> dict[str, int]:
        """Monotonic per-plane sample counts since start -- the correct
        baseline for "what happened between T0 and T1" deltas."""
        with self._lock:
            return dict(self._plane_cum)


PROFILER = SamplingProfiler()
