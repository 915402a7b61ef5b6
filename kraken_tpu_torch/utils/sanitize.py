"""The asyncio stall sanitizer for test runs.

The port's copy of ``kraken_tpu.utils.sanitize``: with it armed, any
on-loop stall past the threshold -- whatever call produced it -- is
recorded with the loop thread's blame stack (the same ``fold_stack``
capture the sampler and the loop-lag monitor use), and
:func:`sanitized_run` fails the run that caused it.

Mechanism (a stalled loop cannot observe itself):

- a heartbeat callback re-arms itself with ``loop.call_later`` every
  ``threshold/4`` seconds and stamps ``time.monotonic()``;
- a watchdog *thread* checks the stamp; when it goes stale past the
  threshold it folds the loop thread's stack;
- stacks whose leaf is the selector/queue idle set are discarded: a
  starved-but-idle loop is scheduling latency, not a blocking callback
  (``classify_plane``'s ``idle``);
- one violation is recorded per stall episode.

asyncio's own debug mode is enabled too (``loop.set_debug(True)`` and
``slow_callback_duration``). The port's in-process operator tests run
their nodes under :func:`sanitized_run`.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import time

from kraken_tpu_torch.utils.profiler import classify_plane, fold_stack

DEFAULT_THRESHOLD_SECONDS = 1.0


class StallViolation:
    """One on-loop stall episode caught by the watchdog."""

    __slots__ = ("stall_seconds", "blame")

    def __init__(self, stall_seconds: float, blame: str):
        self.stall_seconds = stall_seconds
        self.blame = blame

    def render(self) -> str:
        return (
            f"event loop stalled >= {self.stall_seconds:.2f}s in: "
            f"{self.blame}"
        )


class _Watchdog:
    """Thread watching one loop's heartbeat stamp."""

    def __init__(self, loop_thread_id: int, threshold_s: float,
                 violations: list):
        self._loop_tid = loop_thread_id
        self._threshold = threshold_s
        self._violations = violations
        self._beat = time.monotonic()
        self._beat_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kt-sanitize-watchdog", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def beat(self) -> None:
        with self._beat_lock:
            self._beat = time.monotonic()

    def _run(self) -> None:
        armed = True
        poll = max(0.01, self._threshold / 8.0)
        while not self._stop.wait(poll):
            with self._beat_lock:
                stale = time.monotonic() - self._beat
            if stale < self._threshold:
                armed = True  # heartbeat recovered: next stall is new
                continue
            if not armed:
                continue  # same episode: already blamed
            frame = sys._current_frames().get(self._loop_tid)
            if frame is None:
                continue
            frames = fold_stack(frame)
            del frame
            # A starved loop parked in its selector is scheduling
            # latency (rig load), not a blocking callback -- the
            # invariant this sanitizer enforces is about callbacks.
            if classify_plane(frames) == "idle":
                continue
            armed = False
            self._violations.append(
                StallViolation(stale, ";".join(frames))
            )


def sanitized_run(coro, *, threshold_seconds: float | None = None,
                  violations: list | None = None, _run=None, **kw):
    """Drop-in ``asyncio.run`` wrapper: runs ``coro`` with asyncio debug
    on and the stall watchdog armed, appending :class:`StallViolation`s
    to ``violations``. ``_run`` overrides the underlying runner (the
    conftest wrapper chains it after the task-leak tripwire's)."""
    if threshold_seconds is None:
        threshold_seconds = DEFAULT_THRESHOLD_SECONDS
    sink: list = violations if violations is not None else []

    async def wrapper():
        loop = asyncio.get_running_loop()
        loop.set_debug(True)
        loop.slow_callback_duration = threshold_seconds
        dog = _Watchdog(
            threading.get_ident(), threshold_seconds, sink
        )
        interval = max(0.01, threshold_seconds / 4.0)
        handle = None

        def heartbeat() -> None:
            nonlocal handle
            dog.beat()
            handle = loop.call_later(interval, heartbeat)

        heartbeat()
        dog.start()
        try:
            return await coro
        finally:
            if handle is not None:
                handle.cancel()
            dog.stop()

    runner = _run if _run is not None else asyncio.run
    result = runner(wrapper(), **kw)
    if violations is None and sink:
        raise AssertionError(
            "KT_SANITIZE caught on-loop stalls:\n"
            + "\n".join(v.render() for v in sink)
        )
    return result
