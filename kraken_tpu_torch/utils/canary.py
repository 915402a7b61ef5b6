"""Synthetic canary prober: keep the SLO plane fed at zero traffic.

The port's copy of ``kraken_tpu.utils.canary``. Every SLI recorder in
``utils/slo.py`` is request-driven, so a quiet fleet with a dead origin
reads as a healthy one. The canary closes that blind spot: a task on the
agent periodically seeds a small deterministic blob (:func:`canary_blob`)
through an origin and pulls it through the real stack -- origin upload,
metainfo generation (on the card on a ``cuda`` origin), tracker announce,
the p2p wire, piece verify (on the card on a ``cuda`` agent) -- recording
each stage into the same SLO recorders user traffic feeds, labelled
``canary=True`` (``slo_events_total{sli,result,canary="1"}``).

Canary blobs live under the reserved :data:`CANARY_NAMESPACE` and are
TTL-reaped from the agent store and the seeding origin; the reap state
survives a crash in ``<store>/canary-state.json``. Each probe's payload is
derived from (node, boot epoch, sequence), so the bytes of a probe can be
recreated from its document and a pull is never a warm-cache no-op. Probe
roots are always trace-sampled, so every probe's trace joins agent,
tracker and origin.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import logging
import os
import time

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.utils import trace
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter
from kraken_tpu_torch.utils.slo import CANARY_NAMESPACE, SLO

_log = logging.getLogger("kraken.canary")


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """The YAML ``canary:`` section (agent; SIGHUP live-reloads).
    Shipped OFF: enabling is a rollout decision that needs ``origins``
    pointed at the cluster."""

    enabled: bool = False
    # Probe cadence.  At the shipped 60 s / 256 KiB a probe moves
    # ~4 KiB/s amortized -- noise against any real data plane.
    interval_seconds: float = 60.0
    blob_bytes: int = 262144
    # Comma-separated origin http addrs to seed canary blobs through
    # (round-robin).  Empty = prober idles with a one-time WARN.
    origins: str = ""
    # End-to-end bound on the canary pull; a slower pull records BAD.
    pull_timeout_seconds: float = 30.0
    # Canary blobs older than this are deleted from the agent store and
    # the seeding origin (the probe's residue is bounded).
    ttl_seconds: float = 600.0
    upload_chunk_bytes: int = 65536

    @classmethod
    def from_dict(cls, doc: dict | None) -> "CanaryConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown canary config keys: {sorted(unknown)}")
        cfg = cls(**doc)
        if cfg.interval_seconds <= 0 or cfg.pull_timeout_seconds <= 0:
            raise ValueError(
                "canary interval_seconds and pull_timeout_seconds"
                " must be > 0"
            )
        if cfg.blob_bytes <= 0:
            raise ValueError("canary blob_bytes must be > 0")
        return cfg


def canary_blob(node: str, seq: int, size: int, epoch: int = 0) -> bytes:
    """Deterministic probe payload: a SHA-256 counter stream keyed by
    (node, epoch, seq).  Reproducible offline from the probe document
    (which records epoch + seq), unique per probe -- the boot epoch
    keeps a restarted agent from regenerating its previous run's
    digests, which would make early probes warm-cache no-ops."""
    out = bytearray()
    i = 0
    while len(out) < size:
        out += hashlib.sha256(
            f"kraken-canary:{node}:{epoch}:{seq}:{i}".encode()
        ).digest()
        i += 1
    return bytes(out[:size])


class CanaryProber:
    """One per agent node.  Constructed always (the loop gates on
    ``config.enabled`` every tick, so a SIGHUP can turn the canary on
    without a restart); ``start()`` spawns the loop, ``stop()`` reaps
    it and every canary blob it seeded."""

    def __init__(self, store, scheduler, config: CanaryConfig | dict | None,
                 node: str = "agent"):
        self.store = store
        self.scheduler = scheduler
        self.config = (
            config if isinstance(config, CanaryConfig)
            else CanaryConfig.from_dict(config)
        )
        self.node = node
        # Boot epoch: part of the blob derivation, so a restarted agent
        # never regenerates its previous run's digests.
        self._epoch = int(time.time())
        self._seq = 0
        self._rr = 0  # round-robin origin cursor
        # seq -> (digest, origin_addr, wall_ts) awaiting TTL reap.
        # Wall clock (not monotonic): the set persists across restarts
        # via the state sidecar below, and a crashed agent's leftovers
        # must still age out on the next boot's sweep.
        self._live: dict[int, tuple[Digest, str, float]] = {}
        # Crash-safe reap state: without it, an OOM-killed agent
        # permanently orphans up to ttl/interval canary blobs on the
        # origin (nothing else ever deletes the reserved namespace).
        self._state_path = os.path.join(store.root, "canary-state.json")
        self._load_state()
        self._task: asyncio.Task | None = None
        self._warned_no_origins = False
        self._failures = FailureMeter(
            "canary_probe_errors_total",
            "Canary probes that raised outside the recorded stages",
            _log,
        )
        self._c_probes = REGISTRY.counter(
            "canary_probes_total",
            "Synthetic canary probes, by result (ok/upload_fail/"
            "pull_fail/verify_fail)",
        )
        self._c_reaps = REGISTRY.counter(
            "canary_reaps_total",
            "Canary blobs TTL-reaped (agent store + seeding origin)",
        )
        self._h_stage = REGISTRY.histogram(
            "canary_stage_seconds",
            "Canary probe stage walls (upload, pull, plus the dispatcher"
            " stage split of the pull)",
        )

    # -- crash-safe reap state ---------------------------------------------

    def _load_state(self) -> None:
        try:
            with open(self._state_path) as f:
                doc = json.load(f)
            self._seq = int(doc.get("seq", 0))
            for row in doc.get("live", []):
                self._live[int(row["seq"])] = (
                    Digest.from_hex(row["digest"]),
                    str(row["origin"]),
                    float(row["ts"]),
                )
        except FileNotFoundError:
            return
        except Exception:
            # A torn sidecar loses at most ttl_seconds of reap targets;
            # never fail the prober over it.
            _log.warning("canary state unreadable; starting fresh",
                         extra={"path": self._state_path}, exc_info=True)

    def _save_state(self) -> None:
        try:
            doc = {
                "epoch": self._epoch,
                "seq": self._seq,
                "live": [
                    {"seq": seq, "digest": d.hex, "origin": addr, "ts": ts}
                    for seq, (d, addr, ts) in sorted(self._live.items())
                ],
            }
            tmp = self._state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self._state_path)
        except Exception:
            _log.warning("canary state write failed",
                         extra={"path": self._state_path}, exc_info=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                # The loop already meters probe failures; a throw on the
                # way OUT is prober plumbing -- log it, don't lose it.
                _log.debug("canary loop raised at stop", exc_info=True)
            self._task = None
        # Best-effort, BOUNDED residue sweep: deletes run concurrently
        # (below) and the whole pass is capped so a dead origin cannot
        # stall a SIGTERM past the pod grace period -- anything left
        # persists in the state sidecar and reaps on the next boot.
        try:
            await asyncio.wait_for(self._reap(now=float("inf")), 10.0)
        except asyncio.TimeoutError:
            pass  # bounded by design: residue reaps on next boot
        except Exception:
            _log.debug("final canary reap failed", exc_info=True)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_seconds)
            cfg = self.config
            if not cfg.enabled:
                # A disabled canary must not leave its last verdict on
                # /debug/slo forever: one pull_fail recorded just
                # before an operator SIGHUP-disabled probing would gate
                # `kraken-tpu status` red until process restart.
                SLO.canary_status = None
                continue
            from kraken_tpu_torch.tracker.client import parse_tracker_addrs

            origins = parse_tracker_addrs(cfg.origins)
            if not origins:
                if not self._warned_no_origins:
                    self._warned_no_origins = True
                    _log.warning(
                        "canary enabled but no origins configured;"
                        " probes are idle (set canary.origins)"
                    )
                SLO.canary_status = None
                continue
            self._warned_no_origins = False
            try:
                await self.probe(origins)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # probe() records its own stage failures; anything that
                # escapes is prober plumbing, metered not fatal.
                self._failures.record("canary probe", e)
            try:
                await self._reap()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._failures.record("canary reap", e)

    # -- one probe ---------------------------------------------------------

    async def probe(self, origins: list[str] | None = None) -> dict:
        """One full synthetic pull.  Callable directly (tests, an
        operator REPL) -- returns the probe document that also lands on
        ``/debug/slo`` under ``canary``."""
        from kraken_tpu_torch.origin.client import BlobClient

        cfg = self.config
        if origins is None:
            # One parser for every comma-separated addr-list knob
            # (tracker/client.py -- the blessed shape, whitespace
            # tolerated).
            from kraken_tpu_torch.tracker.client import parse_tracker_addrs

            origins = parse_tracker_addrs(cfg.origins)
        if not origins:
            raise ValueError("canary probe needs at least one origin addr")
        self._seq += 1
        seq = self._seq
        origin_addr = origins[self._rr % len(origins)]
        self._rr += 1
        blob = canary_blob(self.node, seq, cfg.blob_bytes, self._epoch)
        d = Digest.from_bytes(blob)
        doc: dict = {
            "seq": seq, "epoch": self._epoch, "digest": d.hex,
            "origin": origin_addr, "bytes": cfg.blob_bytes,
            "ts": time.time(), "result": "ok", "stages": {},
            # Staleness fence for consumers: `kraken-tpu status` must
            # not gate on a verdict older than a few probe intervals
            # (a stopped prober's last document is history, not state).
            "interval_seconds": cfg.interval_seconds,
        }
        with trace.span(
            "canary.probe", seq=seq, digest=d.hex[:12], origin=origin_addr,
        ) as sp:
            if sp is not None:
                # Probes are rare and exist to leave evidence: force the
                # sampling verdict BEFORE any child span is created so
                # the whole upload+pull joins one kept trace.
                sp.sampled = True
                doc["trace_id"] = sp.trace_id
            oc = BlobClient(origin_addr)
            try:
                # Register for reaping BEFORE the upload: a commit PUT
                # that times out client-side may still have committed
                # (and seeded, and replicated) on the origin -- an
                # entry recorded only on observed success would orphan
                # that blob forever.  A truly-failed upload just costs
                # one 404 DELETE at reap time.
                self._live[seq] = (d, origin_addr, time.time())
                # Off-loop: the state write must not add loop-lag on a
                # saturated disk (the very degradation a probe exists
                # to surface).
                await asyncio.to_thread(self._save_state)
                # Stage 1: seed through the real origin upload path.
                t0 = time.monotonic()
                try:
                    await oc.upload(
                        CANARY_NAMESPACE, d, blob,
                        chunk_size=cfg.upload_chunk_bytes,
                    )
                    upload_s = time.monotonic() - t0
                    # The origin's commit handler records the canary-
                    # unaware server-side "upload" SLI; this is the
                    # CLIENT-visible canary upload sample.
                    SLO.record("upload", True, upload_s, canary=True)
                    doc["stages"]["upload_s"] = round(upload_s, 3)
                    self._h_stage.observe(upload_s, stage="upload")
                except Exception as e:
                    SLO.record(
                        "upload", False, time.monotonic() - t0, canary=True
                    )
                    doc["result"] = "upload_fail"
                    doc["error"] = repr(e)
                    return self._finish_probe(doc, sp)
                # Stage 2: pull through the real swarm stack (announce
                # -> tracker fleet -> origin peer -> p2p wire ->
                # verify).  The scheduler coalesces, so a concurrent
                # user pull of the same digest (impossible: the digest
                # is probe-unique) can't skew the sample.
                t0 = time.monotonic()
                try:
                    await asyncio.wait_for(
                        self.scheduler.download(CANARY_NAMESPACE, d),
                        cfg.pull_timeout_seconds,
                    )
                    pull_s = time.monotonic() - t0
                    ok = True
                except Exception as e:
                    pull_s = time.monotonic() - t0
                    ok = False
                    doc["result"] = "pull_fail"
                    doc["error"] = repr(e)
                doc["stages"]["pull_s"] = round(pull_s, 3)
                self._h_stage.observe(pull_s, stage="pull")
                if ok:
                    # Stage 3: end-to-end verification -- the pulled
                    # bytes must BE the deterministic payload (piece
                    # verify already proved digest integrity; this
                    # proves the whole chain addressed the right blob).
                    verified = await asyncio.to_thread(
                        self._verify_local, d, blob
                    )
                    if not verified:
                        ok = False
                        doc["result"] = "verify_fail"
                SLO.record("pull", ok, pull_s, canary=True)
                if ok:
                    # The dispatcher's per-stage split of this very pull --
                    # where a slow canary spent its time.
                    stages = self.scheduler.stage_walls(d)
                    if stages:
                        doc["stages"].update(stages)
                        for stage, wall in stages.items():
                            self._h_stage.observe(
                                wall, stage=stage.removesuffix("_s")
                            )
                return self._finish_probe(doc, sp)
            finally:
                # Close only -- accounting happens at the completed
                # exits above, so a probe CANCELLED mid-pull (SIGTERM,
                # drain) is never counted as an "ok" probe it was not.
                await oc.close()

    def _finish_probe(self, doc: dict, sp) -> dict:
        """Completed-probe accounting: the verdict counter, the span
        status, and the /debug/slo canary document."""
        self._c_probes.inc(result=doc["result"])
        if doc["result"] != "ok" and sp is not None:
            sp.mark_error(doc.get("error", doc["result"]))
        doc["duration_s"] = round(time.time() - doc["ts"], 3)
        SLO.canary_status = doc
        return doc

    def _verify_local(self, d: Digest, blob: bytes) -> bool:
        try:
            r = self.store.open_cache_reader(d)
        except Exception:
            return False
        try:
            return r.pread(r.length, 0) == blob
        except Exception:
            return False
        finally:
            r.close()

    # -- reaping -----------------------------------------------------------

    async def _reap(self, now: float | None = None) -> None:
        """Delete canary blobs past TTL from the agent store AND the
        origin that seeded them (plus its swarm presence).  Best-effort
        per blob: an unreachable origin leaves the entry for the next
        sweep rather than leaking it.  Wall-clock aged: entries loaded
        from the state sidecar after a crash reap on the same TTL."""
        from urllib.parse import quote

        from kraken_tpu_torch.utils.httputil import HTTPClient, base_url

        if now is None:
            now = time.time()
        expired = [
            (seq, d, addr) for seq, (d, addr, ts) in self._live.items()
            if now - ts > self.config.ttl_seconds
        ]
        if not expired:
            return
        http = HTTPClient(retries=0, timeout_seconds=5.0)

        async def reap_one(seq: int, d: Digest, addr: str) -> bool:
            try:
                self.scheduler.unseed(d)
                await asyncio.to_thread(self.store.delete_cache_file, d)
            except Exception:
                _log.debug(
                    "local canary blob %s already evicted", d.hex[:8],
                    exc_info=True,
                )
            try:
                await http.delete(
                    f"{base_url(addr)}/namespace/"
                    f"{quote(CANARY_NAMESPACE, safe='')}"
                    f"/blobs/{d.hex}",
                    retry_5xx=False,
                )
            except Exception as e:
                from kraken_tpu_torch.utils.httputil import HTTPError

                if not (isinstance(e, HTTPError) and e.status == 404):
                    # Origin unreachable: retry on the next sweep.
                    return False
            return True

        reaped = 0
        try:
            # Concurrent: N dead-origin timeouts cost ONE timeout of
            # wall, not N (stop() additionally bounds the whole pass).
            results = await asyncio.gather(
                *(reap_one(seq, d, addr) for seq, d, addr in expired)
            )
            for (seq, _d, _addr), ok in zip(expired, results):
                if ok:
                    del self._live[seq]
                    reaped += 1
                    self._c_reaps.inc()
        finally:
            if reaped:
                await asyncio.to_thread(self._save_state)
            await http.close()
