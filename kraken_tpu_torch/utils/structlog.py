"""Structured JSON logs on stdlib logging.

The port's copy of ``kraken_tpu.utils.structlog``: one line of JSON per
record with timestamp, level, logger, component, message, the active
span's ids, and any ``extra={...}`` fields; WARN+ storms rate-limited
per (logger, template).
"""

from __future__ import annotations

import json
import logging
import threading
import time

_RESERVED = frozenset(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {"message", "asctime"}


class StormFilter(logging.Filter):
    """Per-(logger, template) rate limit for WARN+ lines.

    A flapping peer or a crash-looping dependency can emit the same
    WARN thousands of times a second, drowning exactly the
    postmortem-relevant lines. This filter lets the first ``burst``
    records of each (logger name, unformatted template) key through per
    ``window_seconds``, drops the rest, and attaches
    ``suppressed_similar: N`` to the FIRST record of the next window.
    Keyed on the TEMPLATE (``record.msg``), not the formatted message.
    INFO and below pass untouched. Suppressions count on
    ``log_suppressed_total`` so a muted storm is still visible on
    /metrics."""

    def __init__(self, burst: int = 5, window_seconds: float = 60.0,
                 clock=time.monotonic):
        super().__init__()
        self.burst = burst
        self.window_seconds = window_seconds
        self._clock = clock
        self._lock = threading.Lock()
        # key -> [window_start, passed_in_window, suppressed_in_window]
        self._state: dict[tuple[str, str], list[float]] = {}
        self._counter = None  # lazy: metrics imports must stay optional

    def _count_suppressed(self, n: int) -> None:
        try:
            if self._counter is None:
                from kraken_tpu_torch.utils.metrics import REGISTRY

                self._counter = REGISTRY.counter(
                    "log_suppressed_total",
                    "WARN/ERROR lines dropped by the log-storm filter",
                )
            self._counter.inc(n)
        except Exception:  # kt-lint: disable=bare-except  # pragma: no cover - inside the log filter itself: logging or counting here recurses into this very filter
            pass

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno < logging.WARNING:
            return True
        key = (record.name, str(record.msg))
        now = self._clock()
        with self._lock:
            state = self._state.get(key)
            if state is None or now - state[0] >= self.window_seconds:
                suppressed = int(state[2]) if state else 0
                self._state[key] = [now, 1.0, 0.0]
                # Bound the key table: sweep dead keys once a new window
                # opens and the table has grown.
                if len(self._state) > 4096:
                    floor = now - self.window_seconds
                    for k in [k for k, s in self._state.items()
                              if s[0] < floor]:
                        del self._state[k]
                if suppressed:
                    record.suppressed_similar = suppressed
                return True
            if state[1] < self.burst:
                state[1] += 1
                return True
            state[2] += 1
            self._count_suppressed(1)
            return False


def _trace_ids():
    """Lazy bridge to utils.trace (imported on first log line, not at
    module import)."""
    try:
        from kraken_tpu_torch.utils.trace import current_ids
    except Exception:  # pragma: no cover - partial interpreter teardown
        return None
    return current_ids()


class JSONFormatter(logging.Formatter):
    def __init__(self, component: str = ""):
        super().__init__()
        self.component = component

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 3),
            "iso": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if self.component:
            doc["component"] = self.component
        # Lines logged under an active span carry its ids, so `grep
        # trace_id` joins logs to flight-recorder dumps.
        ids = _trace_ids()
        if ids is not None:
            doc["trace_id"], doc["span_id"] = ids
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                doc[k] = v
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


def setup_json_logging(
    component: str = "", level: int = logging.INFO
) -> None:
    """Route the root logger to one JSON line per record on stderr,
    with WARN+ storms rate-limited per (logger, template)."""
    handler = logging.StreamHandler()
    handler.setFormatter(JSONFormatter(component))
    handler.addFilter(StormFilter())
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
