"""Process-wide metrics: counters, gauges, histograms, Prometheus text,
and the debug mux every component app carries.

The port's copy of ``kraken_tpu.utils.metrics`` (stdlib only), with the
same metric names, so a dashboard reads a GPU node as it reads a TPU one:
the typed registry with OpenMetrics exemplars (``utils/trace.py``
registers the provider), the throttled failure meter of the control loops
(:class:`FailureMeter`), and :func:`instrument_app`: the per-endpoint
middleware (``http_requests_total``, latency, in-flight, the server span,
the endpoint labelled by its route template) and the mux -- ``/metrics``,
``/debug/``, ``/debug/slo``, ``/debug/trace``, ``/debug/healthcheck``,
``/debug/resources``, ``/debug/stacks``, ``/debug/pprof/{profile,heap,
looplag}``, ``/debug/failpoints`` and ``/debug/torch-profile``, the
counterpart of the reference's ``/debug/jax-profile``: a
``torch.profiler`` capture of the host, and of the card on a ``cuda``
node, with the CUDA kernels it saw counted by name.

``GET /metrics`` adds ``kernel_launches_total{kernel}``, the hand-written
kernels' launches as their wrappers count them, on both formats; the
reference has no counterpart. :func:`record_data_plane_shard` puts the
forked data-plane workers' counters on their node's mux.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

# One torch.profiler capture at a time, process-wide (Kineto's profiler
# is global state).
_profile_lock = threading.Lock()

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Exemplar provider (utils/trace.py registers its own at import): called
# on every histogram observation, returns the active SAMPLED trace id or
# None. Kept as a module hook so metrics never imports trace (trace
# imports metrics for its counters).
_exemplar_provider = None


def set_exemplar_provider(fn) -> None:
    global _exemplar_provider
    _exemplar_provider = fn


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

    def render(self, exemplars: bool = False) -> Iterable[str]:
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

    def render(self, exemplars: bool = False) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics) with
    OpenMetrics exemplars: when an observation happens under a SAMPLED
    trace span (utils/trace.py), the trace id is attached to the
    observation's bucket, so the p99 on a dashboard links to the one
    concrete trace in /debug/trace that produced it."""

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(buckets))
        # key -> [bucket counts..., +Inf count, sum]
        self._values: dict[tuple, list[float]] = {}
        # key -> {bucket index (len(buckets) = +Inf): (value, trace_id, ts)}
        self._exemplars: dict[tuple, dict[int, tuple]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        provider = _exemplar_provider
        trace_id = provider() if provider is not None else None
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = [0.0] * (len(self.buckets) + 2)
                self._values[key] = row
            bucket = len(self.buckets)  # +Inf
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
                    bucket = min(bucket, i)
            row[-2] += 1  # +Inf
            row[-1] += value  # sum
            if trace_id is not None:
                # Last exemplar per bucket: the freshest concrete trace
                # for each latency regime (O(buckets) memory, no ring).
                self._exemplars.setdefault(key, {})[bucket] = (
                    value, trace_id, time.time()
                )

    def count(self, **labels: str) -> float:
        with self._lock:
            row = self._values.get(self._key(labels))
            return row[-2] if row else 0.0

    def exemplar(self, **labels: str) -> dict[int, tuple]:
        with self._lock:
            return dict(self._exemplars.get(self._key(labels), {}))

    @staticmethod
    def _fmt_exemplar(ex: tuple | None) -> str:
        if ex is None:
            return ""
        value, trace_id, ts = ex
        return f' # {{trace_id="{trace_id}"}} {value} {round(ts, 3)}'

    def render(self, exemplars: bool = False) -> Iterable[str]:
        with self._lock:
            items = [(k, list(row)) for k, row in sorted(self._values.items())]
            exs = {k: dict(v) for k, v in self._exemplars.items()}
        for key, row in items:
            ex = exs.get(key, {}) if exemplars else {}
            for i, b in enumerate(self.buckets):
                lab = key + (("le", repr(b)),)
                yield (
                    f"{self.name}_bucket{_fmt_labels(lab)} {row[i]}"
                    f"{self._fmt_exemplar(ex.get(i))}"
                )
            lab = key + (("le", "+Inf"),)
            yield (
                f"{self.name}_bucket{_fmt_labels(lab)} {row[-2]}"
                f"{self._fmt_exemplar(ex.get(len(self.buckets)))}"
            )
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

    def render(self, exemplars: bool = False) -> str:
        """Prometheus exposition text. ``exemplars=True`` renders the
        OpenMetrics dialect: the exemplar suffix (`# {trace_id="..."}
        value ts`) on histogram buckets that have one, and counter
        FAMILY names without the ``_total`` suffix (OpenMetrics declares
        `# TYPE foo counter` with samples `foo_total`; repeating the
        suffix in the metadata is a parse error that fails the whole
        scrape). Only emitted when the scraper negotiated OpenMetrics
        (classic text parsers reject in-line exemplars; see the Accept
        handling in instrument_app)."""
        with self._lock:  # registration happens from worker threads too
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: list[str] = []
        for m in metrics:
            family = m.name
            if exemplars and m.kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            if m.help:
                lines.append(f"# HELP {family} {m.help}")
            lines.append(f"# TYPE {family} {m.kind}")
            lines.extend(m.render(exemplars=exemplars))
        return "\n".join(lines) + "\n"

    def names(self) -> list[str]:
        """Every registered metric name -- the catalog lint test walks
        this against docs/OPERATIONS.md so the catalog cannot drift."""
        with self._lock:
            return sorted(self._metrics)


REGISTRY = Registry()


def record_hash_pool_metrics(
    pool: str, workers: int, running: int, queued: int,
    registry: Registry = REGISTRY,
) -> None:
    """Per-pool gauges for the host hash-worker pools (`hash_workers`):
    occupancy (busy workers / pool size) says whether the piece pass is
    actually parallel; queue depth says whether the pool is the
    bottleneck (persistently > 0 ⇒ raise `hash_workers`, if cores
    allow). Labeled by pool name so an origin and an agent sharing a
    process stay distinguishable."""
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


def record_data_plane_shard(
    shard: str, *, conns: int, bytes_delta: float, serves_delta: float,
    cpu_seconds: float, bytes_down_delta: float = 0.0,
    pieces_delta: float = 0.0, registry: Registry = REGISTRY,
) -> None:
    """Aggregate one data-plane worker's counters onto the main metrics
    mux (p2p/shardpool.py publishes them over the control channel;
    workers have no HTTP listener of their own). Labeled ``shard=
    "data_plane_shard{n}"`` (seed-serve plane) or ``"leech_shard{n}"``
    (download plane) so a hot shard, an idle shard, and a crash-looping
    shard are distinguishable on one dashboard; deltas keep counter
    semantics across worker restarts. ``bytes_down_delta`` /
    ``pieces_delta`` are the leech plane's receive-side counters and
    stay zero for seed shards."""
    registry.gauge(
        "data_plane_worker_conns",
        "Live seed conns served by each worker shard",
    ).set(conns, shard=shard)
    registry.gauge(
        "data_plane_worker_cpu_seconds",
        "Cumulative CPU (user+sys) of each worker shard",
    ).set(cpu_seconds, shard=shard)
    if bytes_delta:
        registry.counter(
            "data_plane_worker_bytes_sent_total",
            "Piece payload bytes served by worker shards (sendfile path)",
        ).inc(bytes_delta, shard=shard)
    if serves_delta:
        registry.counter(
            "data_plane_worker_serves_total",
            "Piece serves completed by worker shards",
        ).inc(serves_delta, shard=shard)
    if bytes_down_delta:
        registry.counter(
            "data_plane_worker_bytes_received_total",
            "Piece payload bytes received by leech worker shards",
        ).inc(bytes_down_delta, shard=shard)
    if pieces_delta:
        registry.counter(
            "data_plane_worker_pieces_total",
            "Piece payloads landed in the shared ring by leech shards",
        ).inc(pieces_delta, shard=shard)


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


def kernel_launch_lines(openmetrics: bool = False) -> str:
    """``kernel_launches_total{kernel}``: each hand-written kernel's
    launches in this process, as its wrapper counts them (the wrappers'
    ``LAUNCHES``), for the wrappers this process has loaded. A process
    that runs no kernel shows none. The port's own series: the reference
    has no counterpart.

    A wrapper that another thread is still importing (a node's first
    dedup pass imports ``cdc_cuda``) already stands in ``sys.modules``
    without its ``LAUNCHES``: it has launched nothing, and is left out."""
    import sys

    counts: dict[str, int] = {}
    for name in _LAUNCH_MODULES:
        launches = getattr(sys.modules.get(name), "LAUNCHES", None)
        if launches is not None:
            counts.update(launches)
    if not counts:
        return ""
    # OpenMetrics names a counter's family without its _total suffix.
    family = "kernel_launches" if openmetrics else "kernel_launches_total"
    lines = [
        f"# HELP {family} Launches of each hand-written kernel"
        " (its wrapper's count)",
        f"# TYPE {family} counter",
    ]
    lines += [f'kernel_launches_total{{kernel="{k}"}} {v}'
              for k, v in sorted(counts.items())]
    return "\n".join(lines) + "\n"


# -- /debug/torch-profile ---------------------------------------------------

# The capture in flight, if any (guarded by _profile_lock): a node's stop()
# ends it through release_app().
_active_capture: "_Capture | None" = None
# App keys: set while the app's /debug/pprof/heap has turned tracemalloc
# on; the last capture the app's /debug/torch-profile started.
_HEAP_OWNER = "kraken_heap_owner"
_CAPTURE = "kraken_torch_capture"


def _trace_kernels(path: str) -> tuple[dict[str, int], dict[str, float], float | None]:
    """The CUDA kernel events of an exported Chrome trace: (count, summed
    seconds) by kernel name, and the seconds the trace's own session
    event spans (None without one)."""
    import json

    with open(path) as f:
        doc = json.load(f)
    counts: dict[str, int] = {}
    seconds: dict[str, float] = {}
    window = None
    for ev in doc.get("traceEvents", []):
        cat = str(ev.get("cat", "")).lower()
        if cat == "trace" and "dur" in ev:
            window = max(window or 0.0, float(ev["dur"]) * 1e-6)
        if cat != "kernel":
            continue
        name = str(ev.get("name", "?"))
        counts[name] = counts.get(name, 0) + 1
        seconds[name] = seconds.get(name, 0.0) + float(ev.get("dur", 0.0)) * 1e-6
    return counts, seconds, window


class _Capture:
    """One ``torch.profiler`` capture, started, waited on, stopped and
    exported on one dedicated thread: Kineto keeps per-thread state, and
    two ``asyncio.to_thread`` calls may land on different pool threads.
    The thread releases ``_profile_lock`` itself once the trace is stopped
    and written, so a caller that went away never frees the lock under a
    running profiler (the reference's shielded stop and deferred
    release)."""

    def __init__(self, seconds: float, out_dir: str, device: str, app=None):
        self.app = app
        self.seconds = seconds
        self.out_dir = out_dir
        self.device = device
        self.cancel = threading.Event()
        self.started = threading.Event()  # set once the profiler runs
        self.result: dict | None = None
        self.error: BaseException | None = None
        self.on_done = None
        self.thread = threading.Thread(
            target=self._run, name="kraken-torch-profile", daemon=True
        )

    def _run(self) -> None:
        global _active_capture
        try:
            self.result = self._capture()
        except BaseException as e:  # answered as a 500 naming it
            self.error = e
        finally:
            _active_capture = None
            _profile_lock.release()
            if self.on_done is not None:
                self.on_done()

    def _capture(self) -> dict:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = self.device == "cuda"
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir,
            f"torch-profile-{os.getpid()}-{int(time.time() * 1e3)}.json",
        )
        prof = profile(activities=activities)
        t0 = time.monotonic()
        prof.start()
        t_on = time.monotonic()
        self.started.set()
        try:
            if on_card:
                # One fill on the card inside the window, so that even an
                # idle node's capture shows whether the card is traced.
                torch.ones(1, device="cuda").add_(1)
            self.cancel.wait(self.seconds)
            if on_card:
                torch.cuda.synchronize()
        finally:
            t_off = time.monotonic()
            prof.stop()
        wall = time.monotonic() - t0
        prof.export_chrome_trace(path)
        kernels, kernel_seconds, window = _trace_kernels(path)
        if on_card and not kernels:
            raise RuntimeError(
                "torch.profiler recorded no CUDA activity on a cuda node"
                f" (trace {path}): the card is not being traced"
            )
        return {
            "trace_file": path,
            "seconds": self.seconds,
            "wall_seconds": round(wall, 6),
            # From start() returning to stop() being called, and the
            # span of the trace's own session event.
            "traced_seconds": round(t_off - t_on, 6),
            "trace_window_seconds": None if window is None else round(window, 6),
            "device": self.device,
            "activities": [a.name.lower() for a in activities],
            "kernels": dict(sorted(kernels.items())),
            "kernel_seconds": {
                k: round(v, 9) for k, v in sorted(kernel_seconds.items())
            },
            "cancelled": self.cancel.is_set(),
        }


def stop_profile_capture(app=None, timeout: float = 30.0) -> bool:
    """End the capture in flight, or the last one ``app``'s mux started,
    and wait for its thread to finish its stop and export. True when no
    such capture is left running. Blocking: call it off the loop."""
    cap = _active_capture if app is None else app.get(_CAPTURE)
    if cap is None:
        return True
    cap.cancel.set()
    cap.thread.join(timeout)
    return not cap.thread.is_alive()


def release_app(app) -> None:
    """What a stopping node's mux leaves in the process: a
    ``/debug/torch-profile`` capture it started (ended, and waited for),
    and ``tracemalloc`` if its ``/debug/pprof/heap`` turned it on.
    Blocking: call it off the loop."""
    stop_profile_capture(app)
    if app.get(_HEAP_OWNER):
        from kraken_tpu_torch.utils.profiler import HEAP

        HEAP.stop()
        app[_HEAP_OWNER] = False


def instrument_app(app, component: str, registry: Registry = REGISTRY,
                   profile_device: str = "cpu"):
    """Attach per-endpoint metrics middleware, ``GET /metrics`` and the
    debug mux to an ``http_lite`` app. Endpoint label is the ROUTE
    TEMPLATE (not the raw path: digests in URLs would explode
    cardinality). ``profile_device`` is where the node's kernels run:
    ``/debug/torch-profile`` traces the card too when it is ``cuda``."""
    from kraken_tpu_torch.utils import http_lite as web

    requests = registry.counter(
        "http_requests_total", "HTTP requests by endpoint and status")
    latency = registry.histogram(
        "http_request_duration_seconds", "HTTP request latency")
    inflight = registry.gauge(
        "http_requests_in_flight", "Currently-executing HTTP requests")

    @web.middleware
    async def middleware(request, handler):
        from kraken_tpu_torch.utils import trace

        resource = request.match_info.route.resource
        endpoint = resource.canonical if resource is not None else "unmatched"
        start = time.perf_counter()
        inflight.set(inflight.value(component=component) + 1,
                     component=component)
        status = 499  # client closed request: CancelledError skips all excepts
        # Server span: adopt the caller's traceparent (one trace across
        # agent -> tracker -> origin) or start a fresh sampled-or-not
        # root. The latency histogram below observes INSIDE the span, so
        # its exemplar carries this request's trace id.
        parent = trace.parse_traceparent(request.headers.get("traceparent"))
        with trace.span(
            f"http.server {request.method} {endpoint}",
            parent, component=component,
        ) as sp:
            try:
                resp = await handler(request)
                status = resp.status
                return resp
            except web.HTTPException as e:
                status = e.status
                if e.status >= 500 and sp is not None:
                    sp.mark_error(e)
                raise
            except Exception as e:
                status = 500
                if sp is not None:
                    sp.mark_error(e)
                raise
            finally:
                if sp is not None:
                    sp.set(status=status)
                inflight.set(inflight.value(component=component) - 1,
                             component=component)
                requests.inc(component=component, method=request.method,
                             endpoint=endpoint, status=str(status))
                latency.observe(time.perf_counter() - start,
                                component=component, method=request.method,
                                endpoint=endpoint)

    async def metrics_endpoint(request):
        # Exemplars ride only the OpenMetrics negotiation: classic
        # Prometheus text parsers reject the in-line `# {...}` suffix,
        # so a plain scrape gets the classic format unchanged.
        accept = request.headers.get("Accept", "")
        if "application/openmetrics-text" in accept:
            return web.Response(
                body=(registry.render(exemplars=True)
                      + kernel_launch_lines(openmetrics=True) + "# EOF\n").encode(),
                content_type="application/openmetrics-text",
            )
        return web.Response(
            text=registry.render() + kernel_launch_lines(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def trace_endpoint(request):
        # The flight recorder (utils/trace.py): recent / slowest /
        # errored finished spans, or one trace whole. The postmortem
        # counterpart is the dump-to-JSONL trigger plane; this surface
        # answers "what just happened on THIS node" live.
        from kraken_tpu_torch.utils.trace import TRACER

        view = request.query.get("view", "recent")
        try:
            limit = max(1, min(1000, int(request.query.get("limit", 100))))
        except ValueError:
            return web.Response(status=400, text="malformed limit")
        rec = TRACER.recorder
        if view == "recent":
            spans = rec.recent(limit)
        elif view in ("errors", "errored"):
            spans = rec.errored(limit)
        elif view == "slowest":
            spans = rec.slowest(min(limit, 50))
        elif view == "trace":
            tid = request.query.get("trace_id", "")
            if not tid:
                return web.Response(
                    status=400, text="view=trace requires trace_id"
                )
            spans = rec.trace(tid)
        else:
            return web.Response(
                status=400,
                text="view must be recent|slowest|errors|trace",
            )
        return web.json_response({
            "view": view,
            "sample_rate": TRACER.config.sample_rate,
            "spans": spans,
        })

    async def stacks_endpoint(request):
        # The pprof-goroutine-dump equivalent (the reference exposes Go
        # pprof on its muxes -- SURVEY.md SS5): every thread's stack plus
        # every live asyncio task, for diagnosing a wedged component
        # WITHOUT restarting it. Text, greppable, no state mutated.
        import asyncio
        import sys
        import traceback

        from kraken_tpu_torch.utils.resources import task_census

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"=== thread {tid} ({names.get(tid, '?')}) ===")
            out.extend(
                ln.rstrip() for ln in traceback.format_stack(frame)
            )
        try:
            tasks = asyncio.all_tasks()
        except RuntimeError:
            tasks = set()
        # The census first: "what is this process doing right now" is
        # usually answered by WHICH coroutines dominate, not by reading
        # 8000 individual task stacks. Creation-site tagging from
        # utils/resources.py -- the same sites the sentinel budgets.
        total, top = task_census(top_n=16)
        out.append(f"=== asyncio task census: {total} live ===")
        for site, count in sorted(top.items(), key=lambda kv: -kv[1]):
            out.append(f"  {count:6d}  {site}")
        out.append(f"=== asyncio tasks: {len(tasks)} ===")
        for t in sorted(tasks, key=lambda t: t.get_name()):
            out.append(f"--- {t.get_name()} done={t.done()} ---")
            stack = t.get_stack(limit=6)
            for f in stack:
                out.append(
                    f"  {f.f_code.co_filename}:{f.f_lineno} "
                    f"{f.f_code.co_name}"
                )
        return web.Response(text="\n".join(out), content_type="text/plain")

    async def torch_profile_endpoint(request):
        # The card's half of the tracing plane: a torch.profiler capture
        # (Chrome trace) of the host and, on a cuda node, the card for
        # ?seconds=N (default 2, 0.1-60), answering the CUDA kernels it
        # saw by name. One capture at a time -- the profiler is
        # process-global. ?dir= must resolve under the capture root
        # (KRAKEN_PROFILE_DIR or the system tempdir): this is a debug mux,
        # but it must not be a write-anywhere primitive.
        import asyncio
        import os
        import tempfile

        try:
            seconds = min(60.0, max(0.1, float(request.query.get("seconds", 2))))
        except ValueError:
            return web.Response(status=400, text="malformed seconds")
        root = os.path.realpath(
            os.environ.get("KRAKEN_PROFILE_DIR") or tempfile.gettempdir()
        )
        requested = request.query.get("dir")
        if requested:
            out_dir = os.path.realpath(requested)
            if os.path.commonpath([out_dir, root]) != root:
                return web.Response(
                    status=400,
                    text=f"dir must live under the capture root {root}",
                )
        else:
            # One fixed parent, reused: cleanup is one rm -rf.
            out_dir = os.path.join(root, "kraken-torchprof")
        if not _profile_lock.acquire(blocking=False):
            return web.Response(status=409, text="capture already running")
        global _active_capture
        cap = _Capture(seconds, out_dir, profile_device, request.app)
        loop = asyncio.get_running_loop()
        done = loop.create_future()

        def wake() -> None:
            try:
                loop.call_soon_threadsafe(
                    lambda: done.done() or done.set_result(None)
                )
            except RuntimeError:
                pass  # the loop closed under a capture a node stop ended

        cap.on_done = wake
        _active_capture = request.app[_CAPTURE] = cap
        try:
            cap.thread.start()
        except BaseException:
            _active_capture = None
            _profile_lock.release()
            raise
        try:
            await done
        except asyncio.CancelledError:
            # Client disconnected mid-capture: the stop runs now, on the
            # capture's thread, which frees the lock once it is done.
            cap.cancel.set()
            raise
        if cap.error is not None:
            return web.Response(
                status=500, text=f"torch profile failed: {cap.error!r}"
            )
        return web.json_response(cap.result)

    async def pprof_profile_endpoint(request):
        # The always-on sampling profiler's ring (utils/profiler.py):
        # folded stacks over the last hz x window x keep seconds,
        # worker-shard samples included. Default is the flamegraph
        # collapse ("thread;frames... count" -- `curl > x.folded` feeds
        # any flamegraph tool); ?format=json adds plane split, windows,
        # and per-source sample counts.
        from kraken_tpu_torch.utils.profiler import PROFILER

        if request.query.get("format") == "json":
            return web.json_response(PROFILER.snapshot())
        lines = [f"{stack} {count}" for stack, count in PROFILER.folded()]
        return web.Response(
            text="\n".join(lines) + ("\n" if lines else ""),
            content_type="text/plain",
        )

    async def pprof_heap_endpoint(request):
        # On-demand tracemalloc diff (utils/profiler.py HeapProfiler):
        # first GET starts tracing + baselines, later GETs report the
        # top-N growth sites since; ?reset=1 re-baselines after the
        # diff, ?stop=1 turns tracing back off (it costs real memory).
        import asyncio

        from kraken_tpu_torch.utils.profiler import HEAP, PROFILER

        if request.query.get("stop") == "1":
            request.app[_HEAP_OWNER] = False
            return web.json_response(HEAP.stop())
        try:
            top = max(1, min(100, int(
                request.query.get("top", PROFILER.config.heap_top)
            )))
        except ValueError:
            return web.Response(status=400, text="malformed top")
        # take_snapshot walks every traced block -- off the loop.
        was_tracing = HEAP.tracing
        doc = await asyncio.to_thread(HEAP.diff, top)
        if not was_tracing and HEAP.tracing:
            # This app's node turns it off again when it stops.
            request.app[_HEAP_OWNER] = True
        if request.query.get("reset") == "1":
            await asyncio.to_thread(HEAP.baseline)
        return web.json_response(doc)

    async def pprof_looplag_endpoint(request):
        # Every live loop-lag monitor's percentile view + last stall
        # blame (utils/profiler.py LoopLagMonitor; the histogram
        # loop_lag_seconds is the /metrics counterpart).
        from kraken_tpu_torch.utils.profiler import looplag_snapshot

        return web.json_response(looplag_snapshot())

    async def resources_endpoint(request):
        # "What is this process holding": fds, RSS, task census by
        # creation site, bufpool leases, conns, store debris -- plus
        # every node sentinel's budgets and breach state
        # (utils/resources.py; docs/OPERATIONS.md "Resource budgets").
        # Scrape-guarded: `kraken-tpu status` reads this surface too,
        # so it gates the drain quiesce like /debug/slo.
        from kraken_tpu_torch.utils.resources import debug_snapshot as resources_snap

        return await _guarded_json(request, resources_snap)

    async def healthcheck_endpoint(request):
        # "Why is this replica being skipped": every live health filter
        # and breaker in the process, with per-host state, consecutive
        # fails, remaining open time, probe occupancy, and the latency
        # EWMA driving brown-out shedding (placement/healthcheck.py).
        # Scrape-guarded like /debug/resources above.
        from kraken_tpu_torch.placement.healthcheck import debug_snapshot

        return await _guarded_json(request, debug_snapshot)

    async def _guarded_json(request, build_doc):
        # Debug scrapes gate the lameduck drain quiesce: `kraken-tpu
        # status` reading /debug/slo mid-drain must not have the
        # listener torn down under it.
        # The guard must span the awaited response WRITE, not just the
        # synchronous snapshot: the drain poller shares this event
        # loop, so an await-free hold is invisible to it, and the
        # vulnerable window is the server streaming the body to a slow
        # status client.  prepare()+write_eof() put that transmission
        # INSIDE the guard.  Servers opt in via LameduckMixin.bind_app;
        # bare test apps without a bound server scrape unguarded.
        import contextlib

        from kraken_tpu_torch.utils.lameduck import APP_KEY

        server = request.app.get(APP_KEY)
        guard = (
            server.track_debug_scrape() if server is not None
            else contextlib.nullcontext()
        )
        with guard:
            resp = web.json_response(build_doc())
            await resp.prepare(request)
            await resp.write_eof()
            return resp

    async def slo_endpoint(request):
        # The black-box plane (utils/slo.py): per-SLI burn rates over
        # the paired fast/slow windows, error budget remaining, firing
        # alerts, and the last canary probe -- the document
        # `kraken-tpu status` aggregates fleet-wide.
        from kraken_tpu_torch.utils.slo import SLO

        return await _guarded_json(request, SLO.debug_snapshot)

    async def debug_index_endpoint(request):
        # "Which endpoints does this node have": a JSON index of every
        # registered debug surface plus the core probes, enumerated
        # from the live router so it can never drift from what is
        # actually served.  Operators and `kraken-tpu status` stop
        # guessing.
        def build():
            surfaces: dict[str, list[str]] = {}
            for resource in request.app.router.resources():
                canonical = resource.canonical
                if not (
                    canonical.startswith("/debug")
                    or canonical in ("/metrics", "/health", "/readiness")
                ):
                    continue
                methods = sorted({
                    route.method for route in resource
                    if route.method not in ("HEAD", "OPTIONS", "*")
                })
                if methods:
                    cur = surfaces.setdefault(canonical, [])
                    cur.extend(m for m in methods if m not in cur)
            return {
                "component": component,
                "surfaces": {k: surfaces[k] for k in sorted(surfaces)},
            }

        return await _guarded_json(request, build)

    async def failpoints_get(request):
        # Chaos runbook surface (docs/OPERATIONS.md): list armed sites
        # with hit/fire counts; firings also count on /metrics as
        # failpoints_fired_total{name}.
        from kraken_tpu_torch.utils.failpoints import FAILPOINTS

        return web.json_response(FAILPOINTS.snapshot())

    async def failpoints_post(request):
        # {"action": "arm", "name": ..., "spec": "once"} | {"action":
        # "disarm", "name": ...} | {"action": "disarm_all"}. Arming over
        # HTTP requires the SAME acknowledgement as every other surface:
        # the process must already be allowed (env-armed boot, YAML +
        # KRAKEN_FAILPOINTS_ALLOW, a chaos harness) or carry
        # KRAKEN_FAILPOINTS_ALLOW=1 -- this mux is unauthenticated, and
        # without the gate one curl could arm castore.commit=always on a
        # production origin. Disarming is always allowed (it only ever
        # makes a node healthier).
        import os

        from kraken_tpu_torch.utils.failpoints import FAILPOINTS, allow

        try:
            doc = await request.json()
            action = doc["action"]
            if action == "arm":
                if not (
                    FAILPOINTS.allowed
                    or os.environ.get("KRAKEN_FAILPOINTS_ALLOW") == "1"
                ):
                    return web.Response(
                        status=403,
                        text="arming requires the chaos acknowledgement:"
                             " run this node with KRAKEN_FAILPOINTS_ALLOW=1"
                             " (or boot it with KRAKEN_FAILPOINTS armed)",
                    )
                FAILPOINTS.arm(doc["name"], str(doc.get("spec", "once")))
                allow()  # after a successful, authorized arm only
            elif action == "disarm":
                FAILPOINTS.disarm(doc["name"])
            elif action == "disarm_all":
                FAILPOINTS.disarm_all()
            else:
                raise ValueError(f"unknown action {action!r}")
        except (ValueError, KeyError, TypeError) as e:
            return web.Response(status=400, text=f"malformed request: {e}")
        return web.json_response(FAILPOINTS.snapshot())

    app.middlewares.append(middleware)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/debug", debug_index_endpoint)
    app.router.add_get("/debug/", debug_index_endpoint)
    app.router.add_get("/debug/slo", slo_endpoint)
    app.router.add_get("/debug/trace", trace_endpoint)
    app.router.add_get("/debug/healthcheck", healthcheck_endpoint)
    app.router.add_get("/debug/resources", resources_endpoint)
    app.router.add_get("/debug/stacks", stacks_endpoint)
    app.router.add_get("/debug/pprof/profile", pprof_profile_endpoint)
    app.router.add_get("/debug/pprof/heap", pprof_heap_endpoint)
    app.router.add_get("/debug/pprof/looplag", pprof_looplag_endpoint)
    app.router.add_get("/debug/torch-profile", torch_profile_endpoint)
    app.router.add_get("/debug/failpoints", failpoints_get)
    app.router.add_post("/debug/failpoints", failpoints_post)
    return app
