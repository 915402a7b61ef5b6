"""Process-wide metrics: counters, gauges, histograms, Prometheus text.

The port's own copy of the typed registry in ``kraken_tpu.utils.metrics``
(stdlib only), with the same metric names, so a dashboard reads a GPU node
as it reads a TPU one, and the throttled failure meter of the control loops
(:class:`FailureMeter`), and ``GET /metrics`` on every component app
(:func:`instrument_app`). The per-endpoint middleware, the debug mux,
exemplars and the profiling routes wait for the debug slice (ROADMAP
A7e).
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "counter")
        self._values: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:  # snapshot: writers mutate from worker threads
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Gauge(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "gauge")
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))
        # key -> [bucket counts..., +Inf count, sum]
        self._values: dict[tuple, list[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = [0.0] * (len(self.buckets) + 2)
                self._values[key] = row
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
            row[-2] += 1  # +Inf
            row[-1] += value  # sum

    def count(self, **labels: str) -> float:
        with self._lock:
            row = self._values.get(self._key(labels))
            return row[-2] if row else 0.0

    def render(self) -> Iterable[str]:
        with self._lock:
            items = [(k, list(row)) for k, row in sorted(self._values.items())]
        for key, row in items:
            for i, b in enumerate(self.buckets):
                lab = key + (("le", repr(b)),)
                yield f"{self.name}_bucket{_fmt_labels(lab)} {row[i]}"
            lab = key + (("le", "+Inf"),)
            yield f"{self.name}_bucket{_fmt_labels(lab)} {row[-2]}"
            yield f"{self.name}_count{_fmt_labels(key)} {row[-2]}"
            yield f"{self.name}_sum{_fmt_labels(key)} {row[-1]}"


class Registry:
    """Named metric registry; one process-global default below."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {m.kind}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def render(self) -> str:
        """Prometheus exposition text."""
        with self._lock:  # registration happens from worker threads too
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def record_hash_pool_metrics(
    pool: str, workers: int, running: int, queued: int,
    registry: Registry = REGISTRY,
) -> None:
    """Per-pool gauges for the host hash-worker pools: occupancy (busy
    workers / pool size) and queue depth, labeled by pool name."""
    registry.gauge(
        "hash_pool_workers", "Configured size of the host hash pool"
    ).set(workers, pool=pool)
    registry.gauge(
        "hash_pool_occupancy",
        "Busy hash-pool workers / pool size (sampled at task edges)",
    ).set(running / workers if workers else 0.0, pool=pool)
    registry.gauge(
        "hash_pool_queue_depth",
        "Hash tasks waiting for a free pool worker",
    ).set(queued, pool=pool)


class FailureMeter:
    """Counter + throttled WARN for control loops that must swallow
    failures to keep running (the scheduler's announce loop).

    Every failure counts on the registry; one warning a
    ``throttle_seconds`` is logged, with a count of what it suppressed,
    so a dead tracker is visible without a 1 s retry loop flooding the
    log."""

    def __init__(
        self,
        name: str,
        help_: str,
        logger,
        throttle_seconds: float = 30.0,
    ):
        self.counter = REGISTRY.counter(name, help_)
        self._log = logger
        self._throttle = throttle_seconds
        self._last_warn = -float("inf")
        self._suppressed = 0

    def record(self, what: str, exc: BaseException) -> None:
        self.counter.inc()
        now = time.monotonic()
        if now - self._last_warn >= self._throttle:
            extra = (
                f" ({self._suppressed} similar suppressed)"
                if self._suppressed else ""
            )
            self._log.warning("%s failed: %r%s", what, exc, extra)
            self._last_warn = now
            self._suppressed = 0
        else:
            self._suppressed += 1


# The kernel wrappers whose launch counts /metrics shows, by module.
_LAUNCH_MODULES = (
    "kraken_tpu_torch.ops.sha256_cuda",
    "kraken_tpu_torch.ops.cdc_cuda",
    "kraken_tpu_torch.ops.transpose_cuda",
)


def kernel_launch_lines() -> str:
    """``kernel_launches_total{kernel}``: each hand-written kernel's
    launches in this process, as its wrapper counts them (the wrappers'
    ``LAUNCHES``), for the wrappers this process has loaded. A process
    that runs no kernel shows none. The port's own series: the reference
    has no counterpart."""
    import sys

    counts: dict[str, int] = {}
    for name in _LAUNCH_MODULES:
        mod = sys.modules.get(name)
        if mod is not None:
            counts.update(mod.LAUNCHES)
    if not counts:
        return ""
    lines = [
        "# HELP kernel_launches_total Launches of each hand-written kernel"
        " (its wrapper's count)",
        "# TYPE kernel_launches_total counter",
    ]
    lines += [f'kernel_launches_total{{kernel="{k}"}} {v}'
              for k, v in sorted(counts.items())]
    return "\n".join(lines) + "\n"


def instrument_app(app, component: str, registry: Registry = REGISTRY):
    """Attach ``GET /metrics`` (the registry's Prometheus text, then
    :func:`kernel_launch_lines`) to an ``http_lite`` app. The reference's
    per-endpoint middleware (``http_requests_total``, latency, in-flight,
    the server span) waits for middlewares in ``http_lite`` (ROADMAP
    A7e)."""
    from kraken_tpu_torch.utils import http_lite as web

    async def metrics_endpoint(request):
        text = registry.render() + kernel_launch_lines()
        return web.Response(text=text, content_type="text/plain")

    app.router.add_get("/metrics", metrics_endpoint)
    return app
