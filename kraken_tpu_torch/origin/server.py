"""Origin blobserver: the origin's HTTP API + component assembly.

Mirrors uber/kraken ``origin/blobserver`` (chunked upload start/patch/
commit, GET blob, GET metainfo, stat, forced eviction, replication to ring
peers) -- upstream path, unverified; SURVEY.md SS2.4/SS3.2/SS3.5.

The port's copy of ``kraken_tpu.origin.server``, served by the port's own
HTTP/1.1 (``OriginServer(...).make_app()`` under ``utils/http_lite.serve``).
Where it differs from the reference:

- ``stream_piece_hash`` defaults to the generator's hasher: hashlib piece
  hashes at stream time only for the ``cpu`` hasher. A ``cuda`` origin
  hashes its pieces on the card: through the ingest pipeline's windows at
  stream time when it has one, else in one batched pass at commit. An
  explicit ``stream_piece_hash=True`` still hashes with hashlib.

Endpoints:

    POST   /namespace/{ns}/blobs/{d}/uploads                -> upload id
    PATCH  /namespace/{ns}/blobs/{d}/uploads/{uid}          (X-Upload-Offset)
    PUT    /namespace/{ns}/blobs/{d}/uploads/{uid}/commit
    GET    /namespace/{ns}/blobs/{d}                        -> blob bytes
                                                               (Range-capable:
                                                               delta need-span
                                                               fetches ride it)
    GET    /namespace/{ns}/blobs/{d}/stat                   -> {"size": n}
    GET    /namespace/{ns}/blobs/{d}/metainfo               -> metainfo doc
    GET    /namespace/{ns}/blobs/{d}/similar                -> near-dup list
    GET    /namespace/{ns}/blobs/{d}/recipe                 -> chunk recipe
    GET    /dedup/stats                                     -> corpus stats
    DELETE /namespace/{ns}/blobs/{d}
    GET    /health

On commit: metainfo generates (card batch hash), a writeback task enqueues,
and the blob replicates to its other ring owners (durable retry task).
The origin seeds every cached blob over the P2P plane via its scheduler.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import urllib.parse

from kraken_tpu_torch.utils import http_lite as web

from kraken_tpu_torch.core.digest import Digest, DigestError
from kraken_tpu_torch.backend import BlobNotFoundError
from kraken_tpu_torch.origin.blobrefresh import Refresher
from kraken_tpu_torch.origin.client import BlobClient
from kraken_tpu_torch.core.hasher import record_hash_metrics
from kraken_tpu_torch.core.ingest import IngestConfig, record_stage
from kraken_tpu_torch.origin.metainfogen import Generator
from kraken_tpu_torch.origin.writeback import WritebackExecutor
from kraken_tpu_torch.persistedretry import Manager as RetryManager, Task
from kraken_tpu_torch.placement.hashring import Ring
from kraken_tpu_torch.placement.replicawalk import fan_out_quorum
from kraken_tpu_torch.store import CAStore, FileExistsInCacheError
from kraken_tpu_torch.store.castore import DigestMismatchError, UploadNotFoundError
from kraken_tpu_torch.store.metadata import NamespaceMetadata, pin, unpin
from kraken_tpu_torch.utils import failpoints, trace
from kraken_tpu_torch.utils.deadline import Deadline
from kraken_tpu_torch.utils.lameduck import LameduckMixin
from kraken_tpu_torch.utils.metrics import REGISTRY, FailureMeter

_log = logging.getLogger("kraken.origin")


class _SessionUnadoptable(Exception):
    """A journaled upload session whose spool contradicts its journal:
    the session is discarded and the client restarts the upload."""


class _UploadDigest:
    """Running SHA-256 over an upload's bytes, valid only while every
    PATCH lands at the tracked offset with no concurrent writer.

    With ``piece_length`` set (CPU-hasher origins) it ALSO accumulates
    per-piece digests at that optimistic piece length, so a committed
    upload whose final size maps to the same piece length gets its
    MetaInfo for free -- ingest then touches the bytes exactly once
    (receive -> hash+piece-hash+write), with no post-commit re-read.
    Card origins leave piece hashing to the batched device pass.

    With a ``pool`` (``hash_workers`` origins) completed pieces are
    hashed on pool workers instead of inline: the stream thread then
    pays only the order-dependent blob digest -- the serial term of the
    ingest scaling model -- while piece hashing rides the other cores.
    Piece FRAGMENTS buffer until their piece completes (bounded: at most
    ``2 * workers`` pieces may be in flight before the stream thread
    blocks on the oldest), and the digests come back in piece order.

    With a ``pipeline`` (core/ingest.py IngestPipeline) arriving bytes
    copy once into a leased staging window and full windows flow through
    the pipeline's pack/transfer/hash stages -- the piece pass rides the
    DEVICE hash plane at stream time (``hasher: cuda`` origins),
    overlapped window-by-window with the stream itself. Supersedes the
    pool path when both are configured."""

    __slots__ = (
        "_hash", "_pos", "_active", "_valid", "created", "hash_seconds",
        "_plen", "_piece", "_piece_len", "_piece_digests",
        "_pool", "_parts", "_futs", "_ses", "_win", "_win_pos",
        "stage_walls", "namespace", "digest_hex", "replayed",
    )

    def __init__(self, piece_length: int = 0, pool=None, pipeline=None):
        import hashlib
        import time

        self.created = time.monotonic()
        self.hash_seconds = 0.0  # cumulative time inside sha updates
        self._hash = hashlib.sha256()
        self._pos = 0
        self._active = False
        self._valid = True
        self._plen = piece_length
        # A session holds no leases or pipeline slots until its first
        # begin_window, so creating it per-tracker is free even for
        # uploads that are started and abandoned.
        self._ses = pipeline.session(piece_length) if (
            pipeline is not None and piece_length
        ) else None
        self._win: memoryview | None = None  # current staging window
        self._win_pos = 0
        self._pool = pool if piece_length and self._ses is None else None
        self._piece = (
            hashlib.sha256()
            if piece_length and self._pool is None and self._ses is None
            else None
        )
        self._piece_len = 0
        self._piece_digests: list[bytes] = []
        self._parts: list[memoryview] = []  # current piece's fragments
        self._futs: list = []  # in-order piece-digest futures (pooled)
        # Per-stage walls of the pipelined piece pass (set by
        # piece_hashes on pipeline trackers; commit puts them on the
        # ingest trace span).
        self.stage_walls: dict | None = None
        # Journal identity (resumable sessions): bound by the first PATCH
        # that knows the route's namespace + claimed digest.
        self.namespace = ""
        self.digest_hex = ""
        # Bytes re-read from the spool to rebuild this tracker's state
        # when a session was re-adopted from its journal (0: live).
        self.replayed = 0

    def bind(self, namespace: str, digest_hex: str) -> None:
        if not self.digest_hex:
            self.namespace = namespace
            self.digest_hex = digest_hex

    @property
    def offset(self) -> int:
        return self._pos

    @property
    def usable(self) -> bool:
        return self._valid and not self._active

    @property
    def active(self) -> bool:
        return self._active

    def begin_patch(self, offset: int) -> bool:
        """False = stop tracking this upload (commit will re-read)."""
        if not self._valid or self._active or offset != self._pos:
            self.invalidate()  # also drops pooled chunk pins
            return False
        self._active = True
        return True

    def end_patch(self) -> None:
        self._active = False

    def invalidate(self) -> None:
        """Stop trusting this tracker: commit falls back to the verifying
        re-read. Called when an exception escapes a PATCH body or the
        spool-file close -- a deferred write error (ENOSPC surfacing at
        close/flush) leaves ``_pos`` ahead of the bytes on disk, and a
        client that resumes at the tracker's offset would otherwise get a
        holey blob committed under a passing digest."""
        self._valid = False
        # Pooled trackers pin request-body chunks via the _parts views
        # (each view keeps its whole parent chunk alive); an invalidated
        # tracker can sit in _upload_digests until the 6h TTL purge, so
        # drop the pins now -- its piece hashes can never be used.
        self._parts = []
        self._futs = []
        if self._ses is not None:
            # Return the session's staging leases to the pool. abort()
            # joins in-flight windows (up to a device hash wall), and
            # invalidate runs ON the event loop from PATCH error paths --
            # hand the wait to a scrap thread.
            import threading

            ses, self._ses = self._ses, None
            self._win = None
            threading.Thread(
                target=ses.abort, name="ingest-abort", daemon=True
            ).start()

    @staticmethod
    def _hash_parts(parts: list[memoryview]) -> bytes:
        import hashlib

        h = hashlib.sha256()
        for p in parts:
            h.update(p)
        return h.digest()

    def write_and_update(self, f, chunk: bytes) -> None:
        f.write(chunk)
        self.absorb(chunk)

    def absorb(self, chunk: bytes) -> None:
        """Advance the hash state over ``chunk`` WITHOUT a spool write --
        the shared half of write_and_update, also the session-adoption
        replay (the bytes are already on disk; only the state is gone)."""
        import time

        t0 = time.perf_counter()
        self._hash.update(chunk)
        self._pos += len(chunk)
        if self._ses is not None:
            # Pipelined stream-time piece pass: ONE copy, straight into
            # the leased staging window (the pipeline's read stage); a
            # full window submits to pack/transfer/hash while the next
            # chunks land in the next window. submit() blocking on
            # windows_in_flight is the stream's backpressure -- this
            # runs on the PATCH flush thread, off-loop.
            self.hash_seconds += time.perf_counter() - t0
            view = memoryview(chunk)
            while view:
                if self._win is None:
                    self._win = self._ses.begin_window()
                    self._win_pos = 0
                take = min(len(view), len(self._win) - self._win_pos)
                self._win[self._win_pos : self._win_pos + take] = view[:take]
                self._win_pos += take
                view = view[take:]
                if self._win_pos == len(self._win):
                    self._ses.submit(self._win_pos)
                    self._win = None
            return
        if self._plen:
            view = memoryview(chunk)
            while view:
                take = min(len(view), self._plen - self._piece_len)
                if self._pool is None:
                    self._piece.update(view[:take])
                else:
                    # Views pin the chunk alive until the worker hashes
                    # it; no copy on the stream thread.
                    self._parts.append(view[:take])
                self._piece_len += take
                view = view[take:]
                if self._piece_len == self._plen:
                    if self._pool is None:
                        import hashlib

                        self._piece_digests.append(self._piece.digest())
                        self._piece = hashlib.sha256()
                    else:
                        parts, self._parts = self._parts, []
                        self._futs.append(
                            self._pool.submit(self._hash_parts, parts)
                        )
                    self._piece_len = 0
        # hash_seconds = serial-digest time only, so the stream-pass
        # gauge stays honest: the backpressure wait below is pool lag,
        # not hashing, and must not be billed here.
        self.hash_seconds += time.perf_counter() - t0
        if self._pool is not None:
            # Bound buffered bytes: block on the OLDEST possibly-
            # unfinished future (FIFO pool) so at most 2*workers
            # unhashed pieces are in flight.
            lag = len(self._futs) - 2 * self._pool.workers
            if lag > 0:
                self._futs[lag - 1].result()

    def completed_piece_prefix(self) -> bytes:
        """Concatenated digests of the in-order prefix of pieces already
        hashed -- NON-blocking (done futures only), journal-tick safe.
        Bytes behind :attr:`offset` but past the prefix are re-verified
        by the adoption replay, so a short prefix only weakens the early
        consistency check, never correctness."""
        if not self._plen:
            return b""
        if self._ses is not None:
            return self._ses.completed_digest_prefix().tobytes()
        if self._pool is not None:
            out = []
            for fut in self._futs:
                if not fut.done() or fut.exception() is not None:
                    break
                out.append(fut.result())
            return b"".join(out)
        return b"".join(self._piece_digests)

    def digest_prefix(self, n_pieces: int) -> bytes:
        """First ``n_pieces`` piece digests, BLOCKING on their windows --
        the adoption replay's consistency check against the journal."""
        if n_pieces <= 0 or not self._plen:
            return b""
        if self._ses is not None:
            return self._ses.digest_prefix(n_pieces).tobytes()
        if self._pool is not None:
            return b"".join(
                fut.result() for fut in self._futs[:n_pieces]
            )
        return b"".join(self._piece_digests[:n_pieces])

    def journal_doc(self) -> dict | None:
        """The resumable-session journal for the CURRENT durable state,
        or None when this tracker can't vouch for the spool (invalidated,
        or never bound to a digest)."""
        if not self._valid or not self.digest_hex:
            return None
        return {
            "version": 1,
            "digest": self.digest_hex,
            "namespace": self.namespace,
            "offset": self._pos,
            "piece_length": self._plen,
            "piece_hashes": self.completed_piece_prefix().hex(),
        }

    def result(self, upload_size: int) -> Digest | None:
        """The digest, or None when tracking was invalidated or the bytes
        seen don't cover the file (sparse/overwritten uploads)."""
        if not self._valid or self._active or self._pos != upload_size:
            return None
        from kraken_tpu_torch.core.digest import SHA256

        return Digest(SHA256, self._hash.hexdigest())

    def piece_hashes(self, upload_size: int, piece_length: int) -> bytes | None:
        """Concatenated per-piece digests, or None when unavailable (not
        tracked, wrong piece length for the final size, or empty blob)."""
        usable = not (
            not self._plen
            or piece_length != self._plen
            or upload_size == 0
            or self.result(upload_size) is None
        )
        if self._ses is not None:
            # Runs off-loop (commit wraps this call in to_thread), so
            # joining the session's in-flight windows here is fine.
            ses, self._ses = self._ses, None
            if not usable:
                # Final size landed in a different piece-length tier (or
                # tracking broke): the stream-time digests are at the
                # WRONG piece length -- drop them; commit falls back to
                # the re-generate pass (itself pipelined).
                ses.abort()
                return None
            if self._win is not None:
                ses.submit(self._win_pos)
                self._win = None
            digests = ses.finish()
            self.stage_walls = {
                **ses.stage_seconds,
                "windows": ses.windows,
                "overlap_ratio": round(ses.overlap_ratio(), 3),
            }
            return digests.tobytes()
        if not usable:
            return None
        if self._pool is not None:
            out = [f.result() for f in self._futs]
            if self._parts:  # short trailing piece
                out.append(self._hash_parts(self._parts))
            return b"".join(out)
        out = list(self._piece_digests)
        if self._piece_len:
            out.append(self._piece.digest())
        return b"".join(out)

REPLICATE_KIND = "replicate"
HEAL_KIND = "heal"
HINT_KIND = "hint"


@dataclasses.dataclass(frozen=True)
class QuorumConfig:
    """The YAML ``quorum:`` section (origin only; SIGHUP live-reloads
    via assembly.OriginNode.reload). Knob table in docs/OPERATIONS.md
    "Write durability".

    ``write_quorum`` is the number of ring replicas -- the committing
    origin counts as one -- that must durably hold a blob before the
    upload commit acks. 1 ships as the compatible default (ack on local
    commit, replication stays async); 2-of-3 is the Dynamo-style sweet
    spot: any single origin loss after the ack leaves a pullable copy.
    This is a SLOPPY quorum: replicas the synchronous push cannot reach
    inside ``push_timeout_seconds`` get a durable HINT (persistedretry
    ``hint`` task) instead of blocking the ack, and the hint replays
    when the partition heals -- or escalates to the heal plane after
    ``hint_ttl_seconds`` away."""

    write_quorum: int = 1
    # How long a hinted handoff waits for its target to return before
    # handing the blob to the heal plane (which re-fetches / re-places
    # against the CURRENT ring membership).
    hint_ttl_seconds: float = 6 * 3600.0
    # Total budget of the synchronous quorum push at commit time: the
    # worst case a partition can add to one upload ack.
    push_timeout_seconds: float = 30.0

    @classmethod
    def from_dict(cls, doc: dict | None) -> "QuorumConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown quorum config keys: {sorted(unknown)}")
        cfg = cls(**doc)
        if cfg.write_quorum < 1:
            raise ValueError("quorum.write_quorum must be >= 1")
        if cfg.hint_ttl_seconds <= 0 or cfg.push_timeout_seconds <= 0:
            raise ValueError("quorum TTL/timeout knobs must be > 0")
        return cfg


def _replication_task(addr: str, ns: str, d: Digest) -> Task:
    """The one replication Task shape. The upload path and the repair path
    MUST build identical (kind, key) pairs or the dedup that makes repair
    idempotent silently breaks. Digest-first key: the unpin logic prefix-
    scans pending tasks by blob."""
    return Task(
        kind=REPLICATE_KIND,
        key=f"{d.hex}:{ns}:{addr}",
        payload={"addr": addr, "namespace": ns, "digest": d.hex},
    )


def _hint_task(addr: str, ns: str, d: Digest, expires_at: float) -> Task:
    """Hinted handoff journal entry: (replica, ns, digest, expiry). Same
    digest-first key shape as replication so the unpin logic's prefix
    scan covers hints too; dedups against a pending hint for the same
    (blob, target) from an earlier commit."""
    return Task(
        kind=HINT_KIND,
        key=f"{d.hex}:{ns}:{addr}",
        payload={
            "addr": addr, "namespace": ns, "digest": d.hex,
            "expires_at": expires_at,
        },
    )


def _heal_task(ns: str, d: Digest) -> Task:
    """Restore a quarantined blob from healthy ring replicas (backend
    read-through fallback). Rides the persistedretry plane so a heal
    that cannot succeed NOW (every replica down, backend flapping)
    retries with backoff until the cluster recovers -- corruption must
    never be forgotten just because the first re-fetch failed."""
    return Task(
        kind=HEAL_KIND,
        key=f"{d.hex}:{ns}",
        payload={"namespace": ns, "digest": d.hex},
    )


class OriginServer(LameduckMixin):
    """HTTP facade over the origin's storage plane."""

    lameduck_component = "origin"

    def __init__(
        self,
        store: CAStore,
        generator: Generator,
        refresher: Refresher | None = None,
        writeback: WritebackExecutor | None = None,
        retry: RetryManager | None = None,
        ring: Ring | None = None,
        self_addr: str = "",
        scheduler=None,  # p2p Scheduler seeding our blobs (optional)
        dedup=None,  # origin.dedup.DedupIndex (optional)
        cleanup=None,  # store.cleanup.CleanupManager (optional)
        # None: hashlib at stream time only on ``cpu``-hasher origins.
        stream_piece_hash: bool | None = None,
        rpc=None,  # utils.deadline.RPCConfig (optional)
        delta=None,  # p2p.delta.DeltaConfig (optional; gates /recipe)
        ingest_pipeline=None,  # core.ingest.IngestPipeline (optional)
        # None: the ingest pipeline's config (IngestConfig.resume,
        # .serve_while_ingest), read live; with no pipeline, on and off.
        ingest_resume: bool | None = None,  # journal + re-adopt sessions
        serve_while_ingest: bool | None = None,  # seed from the spool
        quorum: QuorumConfig | None = None,  # write-durability contract
    ):
        if stream_piece_hash is None:
            # A card origin's pieces are hashed on the card; hashlib at
            # stream time would hide it (ROADMAP §C).
            stream_piece_hash = (
                generator is not None and generator.hasher.name == "cpu"
            )
        self.store = store
        self.generator = generator
        self.refresher = refresher
        self.writeback = writeback
        self.retry = retry
        self.ring = ring
        self.self_addr = self_addr
        self.scheduler = scheduler
        self.dedup = dedup
        self.cleanup = cleanup
        # rpc: utils.deadline.RPCConfig (hedge/deadline knobs for the
        # heal-plane cluster client; None = defaults).
        self.rpc = rpc
        # quorum: QuorumConfig (write-durability contract -- sync quorum
        # push at commit, hinted handoff, read-repair). write_quorum=1
        # (the default) keeps the legacy ack-on-local-commit behavior.
        # SIGHUP live-swaps (assembly.OriginNode.reload replaces this
        # object; the next commit reads the new knobs).
        self.quorum = quorum if quorum is not None else QuorumConfig()
        # Delta-transfer plane (p2p/delta.py DeltaConfig): when enabled,
        # GET .../recipe serves the blob's ordered CDC chunk table so
        # agents can plan delta pulls. Shipped OFF; SIGHUP live-swaps
        # (assembly.OriginNode.reload replaces this object).
        if delta is None:
            from kraken_tpu_torch.p2p.delta import DeltaConfig

            delta = DeltaConfig()
        self.delta_config = delta
        # Lameduck drain (utils/lameduck.py): /health fails, NEW upload
        # sessions are refused with 503+Retry-After; in-flight
        # PATCH/commit of existing sessions (and established p2p conns)
        # finish. Never exited -- drain precedes stop.
        self._inflight_writes = 0
        self._dedup_tasks: set[asyncio.Task] = set()
        self._heal_cluster = None  # lazy ClusterClient (heal plane)
        # Pooled replica clients for the quorum push: one warm BlobClient
        # (keep-alive aiohttp session) per replica addr, reused across
        # commits. Dialing fresh per commit costs TCP setup + teardown on
        # EVERY quorum-gated ack -- the healthy-path overhead band
        # (test_data_plane_band) is measured against this pool.
        self._push_clients: dict[str, BlobClient] = {}
        self._upload_digests: dict[str, _UploadDigest] = {}
        # Resumable sessions (ingest.resume) + spool seeding
        # (ingest.serve_while_ingest): pinned by the caller, or read from
        # the pipeline's config, so IngestPipeline.apply swaps them live.
        self._resume = ingest_resume
        self._serve_while_ingest = serve_while_ingest
        self._purge_task: asyncio.Task | None = None
        # Optimistic stream-time piece length: the piece-length config is
        # keyed on FINAL blob size (unknown mid-stream), so stream piece-
        # hashing bets on the smallest tier and falls back to the post-
        # commit windowed pass when a huge blob lands in a bigger tier.
        # The pipelined ingest plane (core/ingest.py) makes stream-time
        # piece hashing viable on DEVICE-hasher origins too: the window
        # stream hashes on the card while the upload body streams in.
        self._ingest_pipeline = ingest_pipeline
        self._stream_piece_length = (
            generator.piece_lengths.piece_length(0)
            if (stream_piece_hash or ingest_pipeline is not None)
            and generator is not None
            else 0
        )
        # hash_workers origins hand completed stream-time pieces to the
        # hasher's pool; the PATCH thread then pays only the serial blob
        # digest (core/hasher.py HashPool). A pipeline supersedes it --
        # the pipeline schedules its own workers.
        self._stream_hash_pool = (
            getattr(generator.hasher, "pool", None)
            if self._stream_piece_length and ingest_pipeline is None
            else None
        )
        # A dedup plane that dies per-blob (sqlite sidecar corruption,
        # kernel fault) must be visible on /metrics, not silent.
        self._dedup_failures = FailureMeter(
            "origin_dedup_failures_total",
            "background dedup add_blob failures",
            _log,
        )
        if retry is not None:
            # SLI-wrapped (utils/slo.py): heal/replication lag burning
            # means durability is degrading while every read still
            # works -- the slow-burn ticket window is built for it.
            retry.register(
                REPLICATE_KIND,
                self._with_slo("replication", self._execute_replication),
            )
            retry.register(
                HEAL_KIND, self._with_slo("heal", self._execute_heal)
            )
            # Hint replays are replication by another trigger: same SLI
            # (durability lag burning while reads still work).
            retry.register(
                HINT_KIND,
                self._with_slo("replication", self._execute_hint),
            )
            # Earlier builds keyed tasks '{addr}:{ns}:{hex}'; rewrite any
            # such persisted rows so the digest-first prefix scan in
            # _maybe_unpin sees them (a missed row releases the eviction
            # pin too early).
            retry.store.canonicalize_keys(
                REPLICATE_KIND,
                lambda p: f"{p['digest']}:{p['namespace']}:{p['addr']}",
            )

    def _ingest_knob(self, pinned: bool | None, name: str) -> bool:
        if pinned is not None:
            return pinned
        pipe = self._ingest_pipeline
        return getattr(pipe.config if pipe is not None else IngestConfig(), name)

    @property
    def resume_enabled(self) -> bool:
        return self._ingest_knob(self._resume, "resume")

    @property
    def serve_while_ingest(self) -> bool:
        return self._ingest_knob(self._serve_while_ingest, "serve_while_ingest")

    @staticmethod
    def _with_slo(sli: str, fn):
        """Wrap a persistedretry executor so every run records the SLI:
        a retried task burns the budget once per failed attempt (lag IS
        repeated failure), and the eventual success records how long
        one successful execution takes."""

        async def run(task) -> None:
            import time

            from kraken_tpu_torch.utils.slo import SLO

            t0 = time.monotonic()
            try:
                await fn(task)
            except asyncio.CancelledError:
                raise  # teardown, not a service failure
            except Exception:
                SLO.record(sli, False, time.monotonic() - t0)
                raise
            SLO.record(sli, True, time.monotonic() - t0)

        return run

    # -- app ---------------------------------------------------------------

    def make_app(self) -> web.Application:
        app = web.Application(client_max_size=1 << 30)
        r = app.router
        r.add_post("/namespace/{ns}/blobs/{d}/uploads", self._start_upload)
        r.add_route(
            "HEAD", "/namespace/{ns}/blobs/{d}/uploads/{uid}",
            self._upload_offset,
        )
        r.add_patch("/namespace/{ns}/blobs/{d}/uploads/{uid}", self._patch_upload)
        r.add_put("/namespace/{ns}/blobs/{d}/uploads/{uid}/commit", self._commit)
        r.add_post("/namespace/{ns}/blobs/{d}/adopt", self._adopt)
        r.add_get("/namespace/{ns}/blobs/{d}/stat", self._stat)
        r.add_get("/namespace/{ns}/blobs/{d}/metainfo", self._metainfo)
        r.add_get("/namespace/{ns}/blobs/{d}/similar", self._similar)
        r.add_get("/namespace/{ns}/blobs/{d}/recipe", self._recipe)
        r.add_get("/dedup/stats", self._dedup_stats)
        r.add_get("/namespace/{ns}/blobs/{d}", self._download)
        r.add_delete("/namespace/{ns}/blobs/{d}", self._delete)
        r.add_get("/health", self._health)
        self.add_lameduck_routes(r)
        self.bind_app(app)
        app.cleanup_ctx.append(self._upload_digest_purge_ctx)
        return app

    async def _upload_digest_purge_ctx(self, app):
        """App-lifetime timer purging TTL-expired upload trackers. The
        old sweep only ran when the dict crossed 1024 entries at
        _start_upload time -- an idle origin kept dead trackers (and
        their pinned chunk views / pipeline sessions) for ever."""
        self._purge_task = asyncio.create_task(
            self._purge_upload_digests_loop()
        )
        yield
        self._purge_task.cancel()
        import contextlib

        with contextlib.suppress(asyncio.CancelledError):
            await self._purge_task
        self._purge_task = None

    async def _purge_upload_digests_loop(self) -> None:
        while True:
            await asyncio.sleep(self.UPLOAD_DIGEST_PURGE_SECONDS)
            self.purge_upload_digests()

    def purge_upload_digests(self) -> None:
        """One TTL tick over the tracker dict (timer-driven; also
        callable from tests). Active trackers (a PATCH body streaming
        right now) are never dropped mid-write."""
        import time

        cutoff = time.monotonic() - self.UPLOAD_DIGEST_TTL_SECONDS
        for uid in [
            uid for uid, t in self._upload_digests.items()
            if t.created < cutoff and not t.active
        ]:
            self._drop_upload_digest(uid, reason="ttl")

    def _drop_upload_digest(self, uid: str, reason: str) -> None:
        tracker = self._upload_digests.pop(uid, None)
        if tracker is None:
            return
        if tracker.usable:
            # A still-valid tracker is losing its fast path: its commit
            # (if it ever arrives) falls back to the verifying re-read.
            _log.warning(
                "upload digest tracker evicted while still usable "
                "(reason=%s uid=%s): commit will re-read", reason, uid,
            )
        # Release pipeline staging leases / pinned chunk views NOW --
        # an evicted tracker nobody commits would otherwise hold them
        # until process exit.
        tracker.invalidate()
        REGISTRY.counter(
            "upload_digests_evicted_total",
            "Upload digest trackers dropped before commit (ttl = aged"
            " out; capacity = cap reached, oldest evicted)",
        ).inc(reason=reason)

    def _digest(self, req: web.Request) -> Digest:
        try:
            return Digest.from_str(req.match_info["d"])
        except DigestError:
            raise web.HTTPBadRequest(text="malformed digest")

    # -- degradation plane -------------------------------------------------

    @property
    def inflight_work(self) -> int:
        """Upload PATCH/commit bodies currently streaming, plus
        in-flight debug scrapes (`kraken-tpu status` / the canary plane
        must never lose a listener mid-read) -- the drain loop lets
        these finish before the hard stop."""
        return self._inflight_writes + self.debug_inflight

    async def _brownout_gate(self) -> None:
        """Failpoint ``rpc.brownout.slow`` (and the addr-targeted
        ``rpc.brownout.slow@host:port`` variant for single-process chaos
        herds where the registry is shared): a SLOW-BUT-ALIVE origin --
        the read path stalls for the armed delay but still answers.
        Drives the hedged-read chaos scenarios (tests/test_chaos.py)."""
        hit = failpoints.fire("rpc.brownout.slow") or failpoints.fire(
            f"rpc.brownout.slow@{self.self_addr}"
        )
        if hit:
            await asyncio.sleep(hit.delay_s)

    # -- upload flow -------------------------------------------------------

    async def _start_upload(self, req: web.Request) -> web.Response:
        if self.lameduck:
            # New write sessions are new WORK; a draining node refuses
            # them so the pusher retries a healthy replica now instead
            # of losing a half-streamed upload at the hard stop.
            raise self.drain_unavailable()
        uid = self.store.create_upload()
        # Running digest over sequentially-streamed upload bytes: when the
        # whole upload arrives in offset order (the overwhelmingly common
        # case -- docker pushes and our own clients stream one PATCH),
        # commit verifies against THIS digest instead of re-reading and
        # re-hashing the entire blob. Out-of-order or concurrent PATCHes
        # just invalidate the tracker and commit falls back to the
        # re-read. Entries are removed at commit; ABANDONED uploads
        # (client crashed before committing) age out on the purge timer
        # (_purge_upload_digests_loop), so they can't permanently eat the
        # cap and silently disable the fast path for every future upload.
        # At the hard cap the OLDEST idle tracker is evicted (metered,
        # never a silent drop). Falling back is always correct.
        if len(self._upload_digests) >= self.UPLOAD_DIGEST_CAP:
            victims = sorted(
                (
                    (t.created, k)
                    for k, t in self._upload_digests.items()
                    if not t.active
                ),
            )
            if victims:
                self._drop_upload_digest(victims[0][1], reason="capacity")
        if len(self._upload_digests) < self.UPLOAD_DIGEST_CAP:
            self._upload_digests[uid] = _UploadDigest(
                piece_length=self._stream_piece_length,
                pool=self._stream_hash_pool,
                pipeline=self._ingest_pipeline,
            )
        return web.Response(text=uid)

    UPLOAD_DIGEST_TTL_SECONDS = 6 * 3600.0  # matches upload-spool lifetime
    UPLOAD_DIGEST_PURGE_SECONDS = 300.0  # timer tick for the TTL sweep
    UPLOAD_DIGEST_CAP = 4096  # hard bound on tracked sessions

    async def _patch_upload(self, req: web.Request) -> web.Response:
        uid = req.match_info["uid"]
        try:
            offset = int(req.headers.get("X-Upload-Offset", "0"))
        except ValueError:
            raise web.HTTPBadRequest(text="malformed X-Upload-Offset")
        # A PATCH past the durable spool size of a JOURNALED session
        # would seek past EOF and leave a HOLE under the client's bytes
        # -- exactly what a blind transport retry does after an origin
        # crash lost the tail (the transport retried, the client's
        # offset didn't). 409 sends the client to HEAD for the durable
        # offset and re-send from there. Only journaled sessions get the
        # guard: a journal exists only for sequential tracked streams,
        # so legacy out-of-order clients (first PATCH at a late offset,
        # tracker invalidated, commit re-reads) are untouched. Rewrites
        # at or below the size stay allowed (duplicate retry of a PATCH
        # whose response was lost: same bytes, commit re-reads).
        if offset > 0 and self.resume_enabled:
            doc = await asyncio.to_thread(self.store.read_upload_session, uid)
            if doc is not None:
                try:
                    size = await asyncio.to_thread(
                        self.store.upload_size, uid
                    )
                except UploadNotFoundError:
                    raise web.HTTPNotFound(text="unknown upload")
                if offset > size:
                    raise web.HTTPConflict(
                        text=f"offset {offset} past durable size {size}"
                    )
        # Stream the request body straight into the upload file (one held
        # handle): one PATCH may carry an arbitrarily large body without
        # O(body) RAM or per-chunk reopen syscalls.
        try:
            f = self.store.open_upload_file(uid)
        except UploadNotFoundError:
            raise web.HTTPNotFound(text="unknown upload")
        tracker = self._upload_digests.get(uid)
        if tracker is not None and not tracker.begin_patch(offset):
            tracker = None
        if tracker is not None:
            # Journal identity: the route carries the namespace and the
            # claimed digest; the session journal needs both so a
            # restarted origin can guard the blob (scrub/fsck) and the
            # client can HEAD this URL for the durable offset.
            tracker.bind(
                urllib.parse.unquote(req.match_info["ns"]),
                self._digest(req).hex,
            )
        self._inflight_writes += 1  # drain waits for streaming bodies
        try:
            f.seek(offset)
            # Batch spool writes: a thread hop per MiB costs ~0.5 ms each
            # on this rig -- at 1 GiB that's more wall than the write
            # itself. Accumulate ~8 MiB, then ONE hop covers write+hash
            # (hashlib releases the GIL; neither belongs on the loop).
            pending: list[bytes] = []
            pending_bytes = 0

            def flush(bufs: list[bytes]) -> None:
                # Failpoint origin.patch.write: ENOSPC surfacing mid-
                # stream -- the except below must invalidate the digest
                # tracker (commit re-reads) and the client sees a clean
                # 500, never a holey blob under a passing digest.
                if failpoints.fire("origin.patch.write"):
                    import errno

                    raise OSError(errno.ENOSPC, "failpoint origin.patch.write")
                for b in bufs:
                    if tracker is not None:
                        tracker.write_and_update(f, b)
                    else:
                        f.write(b)
                if tracker is not None and self.resume_enabled:
                    # Durable-progress journal, once per flush batch: the
                    # bytes just written are pushed out of the userspace
                    # buffer FIRST, so the journaled offset never claims
                    # bytes a process crash could lose.
                    self._journal_upload(uid, tracker, f)

            async for chunk in req.content.iter_chunked(1 << 20):
                pending.append(chunk)
                pending_bytes += len(chunk)
                if pending_bytes >= (8 << 20):
                    bufs, pending, pending_bytes = pending, [], 0
                    await asyncio.to_thread(flush, bufs)
            if pending:
                await asyncio.to_thread(flush, pending)
        except BaseException:
            # A failed PATCH (client disconnect, write error) leaves the
            # tracker's position ahead of -- or ambiguous against -- the
            # bytes on disk. Never let a resumed client ride the fast
            # path over a hole: commit must re-read (round-5 ADVICE).
            if tracker is not None:
                tracker.invalidate()
            raise
        finally:
            self._inflight_writes -= 1
            if tracker is not None:
                tracker.end_patch()
            try:
                # Failpoint origin.patch.close: the deferred-write-error
                # case the comment below describes, injectable.
                if failpoints.fire("origin.patch.close"):
                    import errno

                    raise OSError(errno.ENOSPC, "failpoint origin.patch.close")
                f.close()
            except BaseException:
                # Deferred write error surfacing at close (ENOSPC on a
                # buffered file): the hashed byte count exceeds what the
                # spool holds -- same hole risk as above.
                if tracker is not None:
                    tracker.invalidate()
                raise
        return web.Response(status=204)

    # -- resumable sessions ------------------------------------------------

    def _journal_upload(self, uid: str, tracker: _UploadDigest, f) -> None:
        """Persist the session journal (flush thread, off-loop). Best
        effort: a failed journal write only costs resumability, never
        the upload itself."""
        import os

        doc = tracker.journal_doc()
        if doc is None:
            return
        try:
            f.flush()
            if self.store.durability == "fsync":
                os.fsync(f.fileno())
            self.store.write_upload_session(uid, doc)
        except OSError as e:
            _log.warning(
                "upload session journal write failed (upload stays "
                "un-resumable): uid=%s: %s", uid, e,
            )

    async def _upload_offset(self, req: web.Request) -> web.Response:
        """HEAD on the upload URL: the durable offset a resuming client
        re-PATCHes from (X-Upload-Offset). Re-adopts the session from
        its journal when the in-memory tracker is gone (origin restart)
        or invalidated (failed PATCH mid-stream) -- the SAME path either
        way, so crash recovery and mid-stream resume can't diverge. 404
        means the session is unadoptable: restart the upload (possibly
        on another replica)."""
        uid = req.match_info["uid"]
        tracker = self._upload_digests.get(uid)
        if tracker is not None and tracker.active:
            raise web.HTTPConflict(text="a PATCH is in flight")
        if tracker is not None and tracker.usable:
            return web.Response(
                status=200, headers={"X-Upload-Offset": str(tracker.offset)}
            )
        if tracker is not None:
            # Invalidated mid-stream: the journal (durable state) is the
            # truth now; drop the dead tracker and rebuild from disk.
            self._upload_digests.pop(uid, None)
        offset: int | None = None
        if self.resume_enabled:
            try:
                adopted = await asyncio.to_thread(
                    self._adopt_session_sync, uid
                )
            except _SessionUnadoptable as e:
                REGISTRY.counter(
                    "upload_sessions_unadoptable_total",
                    "Journaled upload sessions refused at adoption"
                    " (spool/journal inconsistent): client restarts",
                ).inc()
                _log.warning("upload session unadoptable: uid=%s: %s", uid, e)
                await asyncio.to_thread(self.store.abort_upload, uid)
                raise web.HTTPNotFound(text="session unadoptable")
            if adopted is not None:
                self._upload_digests[uid] = adopted
                offset = adopted.offset
                REGISTRY.counter(
                    "upload_sessions_adopted_total",
                    "Journaled upload sessions re-adopted after an origin"
                    " restart or mid-stream tracker invalidation",
                ).inc()
        if offset is None:
            # No journal (resume off, journal torn, or never tracked):
            # the spool size is still a correct resume point -- commit
            # falls back to the verifying re-read.
            try:
                offset = await asyncio.to_thread(self.store.upload_size, uid)
            except UploadNotFoundError:
                raise web.HTTPNotFound(text="unknown upload")
        return web.Response(
            status=200, headers={"X-Upload-Offset": str(offset)}
        )

    def _adopt_session_sync(self, uid: str) -> _UploadDigest | None:
        """Rebuild an upload tracker from its journal + spool (off-loop).

        Returns None when there is nothing to adopt (no/torn journal --
        the caller degrades to size-based resume). Raises
        :class:`_SessionUnadoptable` when the spool contradicts the
        journal -- the spool is then suspect and the whole session is
        discarded. The replay re-hashes the durable prefix on the host,
        so a resumed stream is bit-identical to an uninterrupted one by
        construction; the journaled piece-hash prefix is checked against
        the replay as an early torn-spool detector."""
        doc = self.store.read_upload_session(uid)
        if doc is None:
            return None
        if failpoints.fire("origin.upload.resume"):
            raise _SessionUnadoptable("failpoint origin.upload.resume")
        try:
            offset = int(doc["offset"])
            plen = int(doc["piece_length"])
            prefix = bytes.fromhex(doc.get("piece_hashes", ""))
            namespace = str(doc.get("namespace", ""))
            digest_hex = str(doc.get("digest", ""))
        except (KeyError, TypeError, ValueError):
            return None  # torn journal: size-based resume still works
        if offset < 0 or plen < 0:
            return None
        try:
            size = self.store.upload_size(uid)
        except UploadNotFoundError:
            # Orphan journal (spool gone): clean it up; nothing to adopt.
            self.store.delete_upload_session(uid)
            return None
        if size < offset:
            raise _SessionUnadoptable(
                f"spool holds {size} bytes, journal claims {offset}"
            )
        if size > offset:
            # Bytes past the journaled offset were written but never
            # journaled: their hash state is unknown -- drop them; the
            # client re-sends from the durable offset.
            self.store.truncate_upload(uid, offset)
        tracker = _UploadDigest(
            piece_length=plen if self._stream_piece_length else 0,
            pool=self._stream_hash_pool,
            pipeline=self._ingest_pipeline,
        )
        tracker.bind(namespace, digest_hex)
        try:
            with open(self.store.upload_path(uid), "rb") as fh:
                while True:
                    chunk = fh.read(1 << 20)
                    if not chunk:
                        break
                    tracker.absorb(chunk)
            if tracker.offset != offset:
                raise _SessionUnadoptable(
                    f"replayed {tracker.offset} bytes, journal claims "
                    f"{offset}"
                )
            if prefix and tracker.digest_prefix(len(prefix) // 32) != prefix:
                raise _SessionUnadoptable("piece-hash prefix mismatch")
            tracker.replayed = offset
        except _SessionUnadoptable:
            tracker.invalidate()
            raise
        except Exception as e:
            tracker.invalidate()
            raise _SessionUnadoptable(f"replay failed: {e}")
        return tracker

    async def _commit(self, req: web.Request) -> web.Response:
        from kraken_tpu_torch.utils.slo import CANARY_NAMESPACE, SLO

        self._inflight_writes += 1
        # Upload SLI (utils/slo.py): the commit is where an upload
        # becomes visible (verify + metainfo gen + seed), so its
        # latency/outcome is the push path's service level.  4xx is the
        # CLIENT's error, not budget burn.
        t0 = asyncio.get_running_loop().time()
        ns = urllib.parse.unquote(req.match_info.get("ns", ""))
        canary = ns == CANARY_NAMESPACE
        try:
            resp = await self._commit_inner(req)
        except web.HTTPException as e:
            if e.status >= 500:
                SLO.record(
                    "upload", False,
                    asyncio.get_running_loop().time() - t0, canary=canary,
                )
            raise
        except Exception:
            SLO.record(
                "upload", False,
                asyncio.get_running_loop().time() - t0, canary=canary,
            )
            raise
        else:
            SLO.record(
                "upload", resp.status < 500,
                asyncio.get_running_loop().time() - t0, canary=canary,
            )
            return resp
        finally:
            self._inflight_writes -= 1

    async def _commit_inner(self, req: web.Request) -> web.Response:
        import time

        uid = req.match_info["uid"]
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        tracker = self._upload_digests.pop(uid, None)
        precomputed: Digest | None = None
        piece_hashes: bytes | None = None
        size = 0
        # Nests under the http.server middleware span; carries the
        # per-stage walls of the pipelined stream-time piece pass so one
        # trace answers "where did this upload's time go".
        with trace.span("origin.ingest.commit", digest=d.hex[:12]) as sp:
            if tracker is not None:
                try:
                    size = self.store.upload_size(uid)
                except UploadNotFoundError:
                    raise web.HTTPNotFound(text="unknown upload")
                precomputed = tracker.result(size)
                if self.generator is not None:
                    # Off-loop: on pooled origins piece_hashes() blocks on
                    # outstanding pool futures and hashes the trailing
                    # partial piece inline -- tens of ms a stalled loop
                    # would charge to every other request and conn pump.
                    t_pieces = time.perf_counter()
                    piece_hashes = await asyncio.to_thread(
                        tracker.piece_hashes,
                        size, self.generator.piece_lengths.piece_length(size),
                    )
                    if sp is not None:
                        sp.set(piece_hashes_s=round(
                            time.perf_counter() - t_pieces, 6))
            early_metainfo = None
            if (
                self.serve_while_ingest
                and piece_hashes is not None
                and self.scheduler is not None
                and size > 0
            ):
                # Every byte is already in the upload spool (commit below
                # is only the verify + rename) and every piece hash is
                # known, so the metainfo is final: publish it NOW and seed
                # from the spool. Agents pulling this blob get pieces
                # before the commit finishes; promote_partial() below
                # repoints the torrent at the cache path once it does.
                try:
                    early_metainfo = await asyncio.to_thread(
                        self.generator.adopt, d, size,
                        self.generator.piece_lengths.piece_length(size),
                        piece_hashes,
                    )
                    self.scheduler.seed_partial(
                        early_metainfo, ns, self.store.upload_path(uid)
                    )
                except Exception:
                    # Early publish is an optimization; the commit path
                    # below publishes authoritatively either way.
                    _log.warning(
                        "serve-while-ingest early publish failed; blob "
                        "serves after commit", exc_info=True,
                    )
                    early_metainfo = None
            hit = failpoints.fire("origin.commit.slow")
            if hit is not None and hit.delay_s:
                await asyncio.sleep(hit.delay_s)
            # Quorum write plane: launch the replica pushes NOW, against
            # the spool bytes, so they overlap the verify+rename below.
            # No-op (None) at the shipped write_quorum: 1.
            quorum_push = self._begin_quorum_push(ns, d, uid)
            t_commit = time.perf_counter()
            try:
                await asyncio.to_thread(
                    self.store.commit_upload, uid, d, precomputed=precomputed
                )
            except UploadNotFoundError:
                await self._abort_quorum_push(quorum_push)
                await self._retract_early_publish(d, early_metainfo)
                raise web.HTTPNotFound(text="unknown upload")
            except DigestMismatchError as e:
                await self._abort_quorum_push(quorum_push)
                await self._retract_early_publish(d, early_metainfo)
                raise web.HTTPBadRequest(text=str(e))
            except FileExistsInCacheError:
                await self._abort_quorum_push(quorum_push)
                if early_metainfo is not None and self.scheduler is not None:
                    # The bytes ARE committed (by a racing uploader): the
                    # early torrent stays valid at the cache path.
                    self.scheduler.promote_partial(d, self.store.cache_path(d))
                return web.Response(status=409, text="already cached")
            if early_metainfo is not None and self.scheduler is not None:
                self.scheduler.promote_partial(d, self.store.cache_path(d))
            commit_s = time.perf_counter() - t_commit
            record_stage("commit", commit_s)
            if sp is not None:
                # digest_from: "stream" when commit_upload took the digest the
                # tracker kept while the body came in (rebuilt by
                # re-reading ``replayed_bytes`` of the spool if the session
                # was re-adopted), "reread" when it re-read the upload to
                # verify it.
                sp.set(size=size, commit_s=round(commit_s, 6),
                       digest_from="stream" if precomputed is not None else "reread",
                       replayed_bytes=tracker.replayed if tracker else 0)
                if tracker is not None and tracker.stage_walls is not None:
                    sp.set(**{
                        f"ingest_{k}": round(v, 6) if isinstance(v, float) else v
                        for k, v in tracker.stage_walls.items()
                    })
            metainfo = early_metainfo
            if piece_hashes is not None:
                if tracker.stage_walls is None:
                    # Stream-time piece hashes cover the final size at the
                    # final piece length: the MetaInfo is free, no re-read
                    # pass. The north-star hasher gauges still move (the
                    # stream path IS the piece-hash plane on cpu origins).
                    # On hash_workers origins hash_seconds counts only the
                    # stream thread's serial blob digest -- the honest
                    # wall bound; piece hashing overlapped it on the pool.
                    # (Pipelined trackers already recorded theirs inside
                    # the pipeline, labeled by the device hasher.)
                    record_hash_metrics(
                        "cpu", size, len(piece_hashes) // 32,
                        tracker.hash_seconds,
                    )
                if metainfo is None:  # early publish already adopted
                    metainfo = await asyncio.to_thread(
                        self.generator.adopt, d, size,
                        self.generator.piece_lengths.piece_length(size),
                        piece_hashes,
                    )
            t_post = time.perf_counter()
            await self._post_commit(ns, d, metainfo=metainfo)
            if sp is not None:
                sp.set(post_commit_s=round(time.perf_counter() - t_post, 6))
            if quorum_push is not None:
                # With write_quorum > 1 the 201 below is a DURABILITY
                # ack, not a local-commit ack -- it waits until enough
                # ring replicas hold the bytes (or their hints are
                # journaled).
                await quorum_push
        return web.Response(status=201)

    async def _retract_early_publish(self, d: Digest, early_metainfo) -> None:
        """Commit failed after a serve-while-ingest early publish: stop
        advertising bytes that will never commit, and drop the published
        metainfo sidecar so `/metainfo` can't hand out a torrent whose
        blob is gone."""
        if early_metainfo is None:
            return
        from kraken_tpu_torch.origin.metainfogen import TorrentMetaMetadata

        if self.scheduler is not None:
            self.scheduler.unseed(d)
        try:
            await asyncio.to_thread(
                self.store.delete_metadata, d, TorrentMetaMetadata
            )
        except OSError as e:
            _log.warning("early-publish metainfo retract failed: %s", e)

    async def _post_commit(self, ns: str, d: Digest, metainfo=None) -> None:
        # Remember the namespace beside the blob: the repair path
        # re-replicates long after the upload request (and its namespace)
        # is gone (store/metadata.py NamespaceMetadata).
        await asyncio.to_thread(
            self.store.set_metadata, d, NamespaceMetadata(ns)
        )
        if metainfo is None:
            metainfo = await self.generator.generate(d)
        if self.scheduler is not None:
            self.scheduler.seed(metainfo, ns)
        # Canary probes (utils/canary.py) are EPHEMERAL by contract:
        # TTL-reaped minutes later, never durable.  Writeback would
        # accumulate ~360 MB/day/agent of permanent backend residue,
        # and ring replicas would hold copies the reap's single-origin
        # DELETE never reaches.  Seeding above is all a probe needs.
        from kraken_tpu_torch.utils.slo import CANARY_NAMESPACE

        if ns == CANARY_NAMESPACE:
            return
        if self.writeback is not None:
            self.writeback.enqueue(ns, d)
        self._enqueue_replication(ns, d)
        self._schedule_dedup(d)

    async def _adopt(self, req: web.Request) -> web.Response:
        """Associate an EXISTING blob with a (new) namespace -- the server
        side of a cross-repo registry mount. Reads through to the SOURCE
        namespace's backend if the cache evicted the bytes, then runs the
        full commit path under the target namespace (namespace sidecar,
        seed, writeback, replication) so the adoption is as durable as an
        upload. 404 if the blob is nowhere to be found."""
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        source = req.query.get("source", ns)
        await self._ensure_local(source, d)
        await self._post_commit(ns, d)
        return web.Response(status=201)

    def _schedule_dedup(self, d: Digest) -> None:
        """Chunk+sketch+index off the request path; failures are non-fatal
        (the sidecar is recomputed on the next touch)."""
        if self.dedup is None:
            return

        # Deferred import: dedup.py pulls the ops planes; a server built
        # WITHOUT a dedup index never schedules this coroutine, and one
        # built with it already paid the import.
        from kraken_tpu_torch.origin.dedup import DedupEvictionRace

        async def run():
            try:
                with trace.span("origin.dedup.add", digest=d.hex[:12]):
                    await self.dedup.add_blob(d)
                await self._maybe_convert_to_chunks(d)
            except DedupEvictionRace:
                # Benign: eviction/DELETE won the race; the blob is gone
                # and must not be indexed. Counted apart from real
                # dedup-plane faults so the failure meter stays a clean
                # signal (round-5 ADVICE).
                REGISTRY.counter(
                    "origin_dedup_eviction_races_total",
                    "add_blob aborted because eviction/DELETE raced it",
                ).inc()
                _log.debug(
                    "dedup add_blob lost an eviction race",
                    extra={"digest": d.hex},
                )
            except Exception as e:
                self._dedup_failures.record(f"dedup add_blob {d.hex[:8]}", e)

        task = asyncio.create_task(run())
        self._dedup_tasks.add(task)
        task.add_done_callback(self._dedup_tasks.discard)

    async def _maybe_convert_to_chunks(self, d: Digest) -> None:
        """Origin-side chunk-tier handover (store/chunkstore.py): once
        the dedup pass persisted the blob's chunk table, convert the
        flat blob to manifest + refcounted chunks -- near-duplicate
        builds then cost unique bytes at rest on the origin too. Gated
        on ``chunkstore.enabled`` (origins opt in AFTER the agent soak
        -- OPERATIONS.md runbook); every read/serve/replicate path is
        chunk-aware, and a conversion failure just leaves the blob
        flat."""
        cs = getattr(self.store, "chunkstore", None)
        if cs is None or not cs.config.enabled or self.dedup is None:
            return
        try:
            if self.store.cache_size(d) < cs.config.min_blob_bytes:
                return
        except KeyError:
            return
        table = await asyncio.to_thread(self.dedup.chunk_table, d)
        if table is None:
            return
        converts = REGISTRY.counter(
            "chunkstore_converts_total",
            "Completed pulls converted to manifest + refcounted chunks, "
            "by outcome (converted / skipped / mismatch / error)",
        )
        res = await asyncio.to_thread(
            self.store.convert_to_chunks, d, table[0], table[1]
        )
        if res is None:
            converts.inc(outcome="mismatch")
            return
        converts.inc(outcome="converted")
        _log.info(
            "blob converted to chunk tier",
            extra={"digest": d.hex, "new_bytes": res["new_bytes"],
                   "dup_bytes": res["dup_bytes"]},
        )

    # -- quorum write plane (sync push + hinted handoff) ---------------------

    def _begin_quorum_push(self, ns: str, d: Digest, uid: str):
        """Launch the quorum push CONCURRENT with the local commit (or
        return None when the plane is off). The pushes stream from the
        upload SPOOL file while commit_upload verifies + renames it in
        a thread, so replica transfer and hashing overlap the local
        work instead of serializing after it -- the healthy-path commit
        overhead band (test_data_plane_band) depends on this. The
        opener falls back to the cache path: a resume round reopening
        after the rename finds the same inode's bytes there."""
        q = self.quorum
        if (
            q.write_quorum <= 1 or self.ring is None or self.retry is None
            or not self.self_addr
        ):
            return None
        # Canary probes are ephemeral by contract (see _post_commit):
        # quorum-pushing them would spray TTL-reaped probe blobs across
        # the ring.
        from kraken_tpu_torch.utils.slo import CANARY_NAMESPACE

        if ns == CANARY_NAMESPACE:
            return None
        spool = self.store.upload_path(uid)

        def open_at(offset: int):
            try:
                f = open(spool, "rb")
            except FileNotFoundError:
                f = self.store.open_cache_file(d)
            try:
                f.seek(offset)
            except OSError:
                f.close()
                raise
            return f

        return asyncio.create_task(self._quorum_push(ns, d, open_at))

    async def _abort_quorum_push(self, push) -> None:
        """Commit failed (unknown upload, digest mismatch, lost race):
        the in-flight pushes are streaming bytes that will never be
        THIS commit's durability promise -- cut them. Replicas verify
        digests independently, so a partial push can never corrupt."""
        if push is None:
            return
        push.cancel()
        try:
            await push
        except asyncio.CancelledError:
            return

    async def _quorum_push(self, ns: str, d: Digest, opener) -> None:
        """Synchronous replica push at commit time (sloppy quorum).

        Fans out to every OTHER ring owner at once under one budget
        (placement/replicawalk.fan_out_quorum) and returns once
        ``write_quorum - 1`` of them confirmed -- the local commit is
        copy #1. Replicas that errored get a durable hint; when the
        quorum itself went unmet (partition wider than the budget), the
        still-in-flight stragglers do too -- THEY are the partitioned
        set the hint plane exists for. Either way the commit acks: a
        partition must degrade durability to hinted, never block
        writes (the Dynamo sloppy-quorum contract)."""
        q = self.quorum
        try:
            replicas = [
                a for a in self.ring.locations(d) if a != self.self_addr
            ]
        except RuntimeError:
            return  # empty ring
        if not replicas:
            return
        need = min(q.write_quorum - 1, len(replicas))
        deadline = Deadline(
            q.push_timeout_seconds, component="origin-quorum"
        )
        clients = [self._push_client(a) for a in replicas]
        ok, failed, abandoned = await fan_out_quorum(
            clients, self._push_replica_op(ns, d, opener),
            need=need, deadline=deadline, op_name="quorum_push",
            # Healthy path: exactly `need` pushes move bytes; the spare
            # replicas join only on a failed primary or after the hedge
            # tick (a browned-out primary must not eat the whole budget
            # before the spares get their shot).
            hedge_delay=min(2.0, q.push_timeout_seconds / 4.0),
        )
        met = len(ok) >= need
        # Failed replicas get a durable hint. Abandoned (still in
        # flight at quorum) replicas are only hinted when the quorum
        # went UNMET -- under a met quorum the async replication task
        # enqueued by _post_commit already owns their convergence.
        for addr in list(failed) + (abandoned if not met else []):
            self._journal_hint(addr, ns, d)
        REGISTRY.counter(
            "origin_quorum_writes_total",
            "Upload commits through the quorum write plane, by outcome"
            " (quorum = enough replicas confirmed before the ack;"
            " hinted = quorum unmet, unreachable replicas journaled as"
            " hints and the ack proceeded)",
        ).inc(outcome="quorum" if met else "hinted")
        if not met:
            _log.warning(
                "quorum unmet at commit: acked via hinted handoff",
                extra={
                    "digest": d.hex, "namespace": ns,
                    "confirmed": len(ok), "needed": need,
                    "hinted": sorted(set(list(failed) + abandoned)),
                },
            )

    def _push_replica_op(self, ns: str, d: Digest, opener):
        """One replica's push: a resumable streaming upload straight
        from the opener (spool-or-cache). No stat probe first -- the
        blob was committed microseconds ago, so the replica all but
        never holds it, and a replica that DOES answers the commit with
        409 = success without a wasted round trip. The partition
        failpoint injects an unreachable replica (globally, or per
        target via the @addr variant)."""

        async def push(c, deadline) -> None:
            hit = failpoints.fire("origin.quorum.replica.partition")
            if hit is None:
                hit = failpoints.fire(
                    f"origin.quorum.replica.partition@{c.addr}"
                )
            if hit:
                if hit.delay_s:
                    await asyncio.sleep(hit.delay_s)
                raise failpoints.FailpointError(
                    f"origin.quorum.replica.partition: {c.addr}"
                )
            await c.upload_from_opener(ns, d, opener, deadline=deadline)

        return push

    def _journal_hint(self, addr: str, ns: str, d: Digest) -> None:
        """Durably journal a hinted handoff for an unreachable replica.
        Rides the persistedretry plane, so the hint survives origin
        restart and replays with backoff until the target returns (or
        the TTL hands it to heal)."""
        assert self.retry is not None
        import time

        added = self.retry.add(
            _hint_task(addr, ns, d, time.time() + self.quorum.hint_ttl_seconds)
        )
        if added:
            self._count_hint("journaled")
            # Pin against eviction until the hint lands -- same same-
            # loop-iteration rule as _add_replication_task (no awaits
            # between enqueue and pin, or a fast unpin races it).
            pin(self.store, d, HINT_KIND)

    async def _execute_hint(self, task: Task) -> None:
        """Replay one hinted handoff.

        Effectively-once: the push is stat-first, so a crash between
        the push landing and the task retiring (the
        ``origin.hint.replay.crash`` window) re-runs as a cheap stat
        hit, never a second byte stream. An expired hint hands the blob
        to the heal plane instead -- the target stayed away so long the
        CURRENT ring owners (which may no longer include it) should be
        made whole rather than one stale address chased forever."""
        import time

        d = Digest.from_hex(task.payload["digest"])
        ns = task.payload["namespace"]
        addr = task.payload["addr"]
        if time.time() >= float(task.payload.get("expires_at", 0.0)):
            self._count_hint("expired")
            self.enqueue_heal(ns, d)
            self._unpin_if_last_hint(d)
            return
        if not self.store.in_cache(d):
            # Local copy gone (explicit DELETE, eviction despite the
            # pin): nothing to push -- the replication plane's
            # without-local handling owns this blob's convergence.
            self._count_hint("lost")
            self._unpin_if_last_hint(d)
            return
        deadline = Deadline(
            self.rpc.request_deadline_seconds if self.rpc else 60.0,
            component="origin-hint",
        )
        peer = BlobClient(addr)
        try:
            if await peer.stat(ns, d, local_only=True, deadline=deadline) is None:
                await peer.upload_from_store(
                    ns, d, self.store, deadline=deadline
                )
        finally:
            await peer.close()
        hit = failpoints.fire("origin.hint.replay.crash")
        if hit:
            # Injected crash AFTER the push, BEFORE the task retires:
            # the replay above must be idempotent across this window.
            raise failpoints.FailpointError("origin.hint.replay.crash")
        self._count_hint("replayed")
        _log.info(
            "hint replayed: replica made whole",
            extra={"digest": d.hex, "namespace": ns, "target": addr},
        )
        self._unpin_if_last_hint(d)

    def _count_hint(self, state: str) -> None:
        REGISTRY.counter(
            "origin_hints_total",
            "Hinted handoffs by state (journaled = partition observed at"
            " commit; replayed = target made whole after recovery;"
            " expired = TTL hit, escalated to heal; lost = local copy"
            " gone before replay)",
        ).inc(state=state)

    def _unpin_if_last_hint(self, d: Digest) -> None:
        """Drop the hint pin once no OTHER pending hint references this
        blob (the current task counts until the manager marks it done)."""
        if self.retry is None:
            return
        if self.retry.store.count_pending(
            HINT_KIND, f"{d.hex}:"
        ) <= 1 and self.store.in_cache(d):
            unpin(self.store, d, HINT_KIND)

    # -- replication to ring peers -----------------------------------------

    def _enqueue_replication(self, ns: str, d: Digest) -> None:
        if self.ring is None or self.retry is None or not self.self_addr:
            return
        for addr in self.ring.locations(d):
            if addr != self.self_addr:
                self._add_replication_task(addr, ns, d)

    def _add_replication_task(self, addr: str, ns: str, d: Digest) -> bool:
        assert self.retry is not None
        added = self.retry.add(_replication_task(addr, ns, d))
        if added:
            # Visible enqueue rate: the heal loop's "replication
            # re-enqueued" claim must be checkable from /metrics.
            REGISTRY.counter(
                "replication_enqueued_total",
                "Replication tasks accepted into the persistedretry queue",
            ).inc()
            # Pin against eviction until the blob lands on every target
            # (otherwise a cleanup sweep can erase the cluster's only copy
            # while the peer is down). Unpinned in _execute_replication.
            # On-loop IO audit (VERDICT r5 #6): pin is a sidecar write ON
            # the loop, DELIBERATELY -- it must land in the same loop
            # iteration as the enqueue (no awaits), or a fast-completing
            # task's unpin races the late pin and leaks it forever (see
            # repair()). Once per commit, not per piece.
            pin(self.store, d, REPLICATE_KIND)
        return added

    def _namespace_for(self, d: Digest) -> str:
        """The namespace a blob was committed under (NamespaceMetadata
        sidecar, written at commit) -- the repair path runs long after the
        upload request is gone."""
        md = self.store.get_metadata(d, NamespaceMetadata)
        return md.namespace if md is not None else "default"

    async def repair(self) -> int:
        """Re-replicate every local blob to its *current* ring owners.

        Called on ring membership change (SURVEY.md SS5 failure detection:
        an origin death must re-place its blobs onto survivors; a revival
        must re-fill the returning host). Idempotent and cheap to re-run:
        tasks dedup on (kind, key) and the executor stats the peer before
        sending bytes. Returns the number of tasks enqueued.

        The disk scan runs off-loop and the enqueue is batched (one sqlite
        transaction per slice) so a ring change on a 100k-blob origin does
        not stall request handling."""
        if self.ring is None or self.retry is None or not self.self_addr:
            return 0

        def _plan() -> list[Task]:
            tasks: list[Task] = []
            for d in self.store.list_cache_digests():
                try:
                    locations = self.ring.locations(d)
                except RuntimeError:
                    break  # empty ring: nothing sane to do
                ns = self._namespace_for(d)
                # If we still own the blob, fill the other owners; if
                # ownership moved entirely (we shrank out of the replica
                # set), hand off to all of them -- cleanup evicts our copy
                # later.
                for addr in locations:
                    if addr != self.self_addr:
                        tasks.append(_replication_task(addr, ns, d))
            return tasks

        tasks = await asyncio.to_thread(_plan)
        enqueued = 0
        for i in range(0, len(tasks), 500):
            batch = tasks[i : i + 500]
            # Pin BEFORE enqueue, same loop iteration (no awaits between):
            # a fast-completing task must find its pin already set, or its
            # unpin runs first and the late pin leaks forever. Skip blobs
            # DELETEd since _plan (pinning would orphan a sidecar).
            for hex_ in {t.payload["digest"] for t in batch}:
                d2 = Digest.from_hex(hex_)
                if self.store.in_cache(d2):
                    pin(self.store, d2, REPLICATE_KIND)
            enqueued += self.retry.add_many(batch)
            await asyncio.sleep(0)  # yield between transactions
        return enqueued

    async def _execute_replication(self, task: Task) -> None:
        d = Digest.from_hex(task.payload["digest"])
        ns = task.payload["namespace"]
        addr = task.payload["addr"]
        if not self.store.in_cache(d):
            await self._handle_replication_without_local(task, d, ns, addr)
            return
        peer = BlobClient(addr)
        try:
            if await peer.stat(ns, d) is None:
                # Stream from the store: replication of a 10 GiB layer
                # must not hold the layer in RAM -- and a chunk-backed
                # blob streams through its composed reader, no flat
                # copy needed.
                await peer.upload_from_store(ns, d, self.store)
        finally:
            await peer.close()
        self._unpin_if_last_replication(d)

    async def _handle_replication_without_local(
        self, task: Task, d: Digest, ns: str, addr: str
    ) -> None:
        """The local copy is gone (explicit DELETE, or eviction despite the
        pin -- e.g. a pre-pin record). Done if ANY current owner holds the
        blob (they replicate onward). The task retires as LOST only when
        every owner positively confirmed a miss; an unreachable owner is
        no evidence -- raise so the retry manager reschedules and re-probes
        after the owner recovers."""
        owners = [a for a in ([] if self.ring is None else self.ring.locations(d))
                  if a != self.self_addr]
        unreachable: Exception | None = None
        # One budget across the whole owner probe sweep: a ring of hung
        # sockets must cost one bounded task attempt, not len(owners)
        # full client timeouts.
        deadline = Deadline(
            self.rpc.request_deadline_seconds if self.rpc else 60.0,
            component="origin-replication",
        )
        for owner in dict.fromkeys([addr, *owners]):
            peer = BlobClient(owner)
            try:
                # local_only: "owner HOLDS the bytes and can replicate
                # onward" -- a durable-backend answer would retire the
                # repair while zero cached copies exist on the ring.
                if await peer.stat(
                    ns, d, local_only=True, deadline=deadline
                ) is not None:
                    self._unpin_if_last_replication(d)
                    return
            except Exception as e:
                unreachable = e
            finally:
                await peer.close()
        if unreachable is not None:
            raise unreachable
        REGISTRY.counter(
            "replication_lost_total",
            "Replication tasks whose blob was confirmed missing on every owner",
        ).inc(component="origin")
        _log.error(
            "replication source lost: every owner confirmed missing",
            extra={"digest": d.hex, "namespace": ns, "target": addr},
        )
        self._unpin_if_last_replication(d)

    def _unpin_if_last_replication(self, d: Digest) -> None:
        """Drop the replication pin once no OTHER pending replicate task
        references this blob (the current task is still counted until the
        retry manager marks it done)."""
        if self.retry is None:
            return
        if self.retry.store.count_pending(
            REPLICATE_KIND, f"{d.hex}:"
        ) <= 1 and self.store.in_cache(d):
            unpin(self.store, d, REPLICATE_KIND)

    # -- self-heal (quarantined blob -> ring re-fetch -> re-replicate) -----

    def enqueue_heal(self, ns: str, d: Digest) -> bool:
        """Queue a durable restore of a quarantined/lost blob. Called by
        the scrubber's corruption hook (assembly wiring); dedups on
        (kind, key) so repeated scrub cycles over a still-broken blob
        don't stack tasks."""
        if self.retry is None:
            return False
        return self.retry.add(_heal_task(ns, d))

    async def _execute_heal(self, task: Task) -> None:
        """Restore one blob bit-identically, then re-converge the ring.

        Source order: healthy ring replicas first (ClusterClient
        ``_try_each`` in ring order, self excluded; arrival is committed
        through the verifying ``commit_upload``, so a replica serving
        wrong bytes can never be adopted), then backend read-through
        (``Refresher`` -- its commit verifies too). Both exhausted ->
        raise, and the retry plane re-runs with backoff until the
        cluster recovers. After restore the FULL commit pipeline runs
        (namespace sidecar, metainfo + seed, writeback, replication,
        dedup), so the ring converges back to max_replica."""
        d = Digest.from_hex(task.payload["digest"])
        ns = task.payload["namespace"]
        source = ""
        if self.store.in_cache(d):
            # A cached copy usually means a racing path (refresh,
            # replication push) already restored the blob -- but it can
            # also be the CORRUPT original whose quarantine move failed
            # on a dying disk (fsck suppresses that OSError yet still
            # enqueues the heal). A heal may declare NOTHING healed
            # unverified: re-hash, and move rot aside before restoring
            # over it (commit refuses to overwrite a cache path). If
            # even the move fails, the raise reschedules the task --
            # better to retry than to re-seed corrupt bytes.
            if await asyncio.to_thread(self._cached_matches, d):
                source = "cached"
            else:
                await asyncio.to_thread(self.store.quarantine_cache_file, d)
        if not source and self.ring is not None:
            cluster = await self._get_heal_cluster()
            uid = self.store.create_upload()
            try:
                await cluster.download_to_file(
                    ns, d, self.store.upload_path(uid)
                )
                await asyncio.to_thread(self.store.commit_upload, uid, d)
                source = "ring"
            except FileExistsInCacheError:
                source = "ring"
            except Exception:
                _log.warning(
                    "heal: no ring replica could serve the blob; trying"
                    " backend read-through",
                    extra={"digest": d.hex, "namespace": ns},
                )
            finally:
                self.store.abort_upload(uid)  # no-op once committed
        if not source:
            if self.refresher is None:
                raise BlobNotFoundError(
                    f"heal: no ring replica and no backend for {d.hex}"
                )
            # Coalesced, verified backend pull (blobrefresh.py); raises
            # BlobNotFoundError when the backend misses too -> retry.
            await self.refresher.refresh(ns, d)
            source = "backend"
        REGISTRY.counter(
            "blob_heals_total",
            "Quarantined/lost blobs restored bit-identically, by source",
        ).inc(source=source)
        _log.info(
            "heal: blob restored",
            extra={"digest": d.hex, "namespace": ns, "source": source},
        )
        # Re-run the commit pipeline: re-seed, re-writeback, and
        # re-enqueue replication so every ring owner is made whole.
        await self._post_commit(ns, d)

    def _cached_matches(self, d: Digest) -> bool:
        """Shared invariant check (``CAStore.verify_cache_file``):
        unreadable (EIO) or vanished both read as 'not a healthy copy'."""
        return self.store.verify_cache_file(d)

    async def _get_heal_cluster(self):
        """One ClusterClient (pooled aiohttp sessions) reused across heal
        executions instead of a dial-everything-fresh per task -- heals
        retry with backoff precisely when the cluster is degraded, the
        worst moment to pay TCP/TLS setup per attempt. Rebuilt if the
        ring or self_addr was swapped after construction (herd harnesses
        attach them post-start); the ring's own health filter already
        keeps dead members out of ``locations``. Closed by assembly at
        node stop."""
        from kraken_tpu_torch.origin.client import ClusterClient

        c = self._heal_cluster
        if (
            c is not None
            and c.ring is self.ring
            and c.exclude_addr == self.self_addr
        ):
            return c
        if c is not None:
            await c.close()
        c = ClusterClient(
            self.ring,
            exclude_addr=self.self_addr,
            # Heals run precisely when some replica is sick: hedged,
            # budgeted reads are the difference between a heal that
            # routes around a brown-out and one that camps on it.
            hedge_delay_seconds=(
                self.rpc.hedge_delay_seconds if self.rpc else None
            ),
            deadline_seconds=(
                self.rpc.request_deadline_seconds if self.rpc else None
            ),
            component="origin-heal",
        )
        self._heal_cluster = c
        return c

    def _push_client(self, addr: str) -> BlobClient:
        """The pooled, keep-alive replica client for ``addr`` (see
        ``_push_clients`` in __init__). Stale addrs from ring churn just
        idle in the pool -- same lifecycle as the heal cluster's."""
        c = self._push_clients.get(addr)
        if c is None:
            c = self._push_clients[addr] = BlobClient(addr)
        return c

    async def close_heal_cluster(self) -> None:
        if self._heal_cluster is not None:
            await self._heal_cluster.close()
            self._heal_cluster = None
        for c in self._push_clients.values():
            await c.close()
        self._push_clients.clear()

    # -- reads -------------------------------------------------------------

    async def _ensure_local(self, ns: str, d: Digest) -> None:
        if self.store.in_cache(d):
            return
        # Read-repair FIRST: a miss on a ring owner is a durability hole
        # (a partition ate the replication push), and a sibling replica
        # is both the cheapest source and the one whose bytes keep the
        # ring converged without a backend round-trip -- pure-p2p
        # deployments have no backend to fall through to at all.
        if await self._read_repair(ns, d):
            return
        if self.refresher is None:
            raise web.HTTPNotFound(text="blob not found")
        try:
            await self.refresher.refresh(ns, d)
        except BlobNotFoundError:
            raise web.HTTPNotFound(text="blob not found (backend miss)")
        self._schedule_dedup(d)

    async def _read_repair(self, ns: str, d: Digest) -> bool:
        """GET-side miss on a ring owner: restore from a sibling replica,
        then re-enqueue replication so the ring reconverges -- the read
        path heals the write path's holes (Dynamo read-repair).

        Siblings are probed with LOCAL-ONLY stats first: a plain GET
        against a sibling that also misses would recurse the repair
        around the ring (its miss handler read-repairs from us, whose
        handler...). Only a sibling that positively holds the bytes is
        streamed from; arrival commits through the verifying
        ``commit_upload``, so a sibling serving rot can never be
        adopted. False = no sibling holds the bytes (the caller falls
        through to backend read-through / 404)."""
        if self.ring is None or not self.self_addr:
            return False
        try:
            if self.self_addr not in self.ring.locations(d):
                return False  # not an owner: plain read-through semantics
        except RuntimeError:
            return False  # empty ring
        cluster = await self._get_heal_cluster()
        deadline = Deadline(
            self.rpc.request_deadline_seconds if self.rpc else 60.0,
            component="origin-read-repair",
        )
        source = None
        for c in cluster.clients_for(d):
            try:
                if await c.stat(
                    ns, d, local_only=True, deadline=deadline
                ) is not None:
                    source = c
                    break
            except Exception:
                # Unreachable sibling: keep walking (the loop IS the
                # failover; a dead replica must not veto the repair).
                _log.debug(
                    "read-repair stat probe failed",
                    extra={"digest": d.hex, "peer": c.addr}, exc_info=True,
                )
                continue
        if source is None:
            return False
        uid = self.store.create_upload()
        try:
            await source.download_to_file(
                ns, d, self.store.upload_path(uid), deadline=deadline
            )
            await asyncio.to_thread(self.store.commit_upload, uid, d)
        except FileExistsInCacheError:
            pass  # a racing restore path won: the bytes are local now
        except Exception:
            _log.warning(
                "read-repair fetch failed; falling through",
                extra={"digest": d.hex, "namespace": ns,
                       "source": source.addr},
                exc_info=True,
            )
            return False
        finally:
            self.store.abort_upload(uid)  # no-op once committed
        REGISTRY.counter(
            "origin_read_repairs_total",
            "Owner GET misses restored from a sibling replica (the ring"
            " then reconverges via re-enqueued replication)",
        ).inc()
        _log.info(
            "read-repair: blob restored from sibling",
            extra={"digest": d.hex, "namespace": ns, "source": source.addr},
        )
        # Full commit pipeline, like heal: namespace sidecar, metainfo +
        # seed, writeback, replication re-enqueue, dedup -- the repaired
        # copy must be as durable (and as advertised) as an uploaded one.
        await self._post_commit(ns, d)
        return True

    async def _stat(self, req: web.Request) -> web.Response:
        await self._brownout_gate()
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        try:
            size = self.store.cache_size(d)
        except KeyError:
            # Not cached. ?local=true keeps cache-only semantics -- the
            # replication lost-check means "do YOU hold the bytes", and a
            # durable-backend answer there would retire repair tasks while
            # ring redundancy is actually zero cached copies.
            if req.query.get("local") == "true" or self.refresher is None:
                raise web.HTTPNotFound(text="blob not found")
            # Possibly durable: answer from a cheap backend stat WITHOUT
            # restoring the bytes. Stat and download must agree -- docker
            # HEADs a blob to decide whether to push it, and a 404 for a
            # blob GET would serve means needless multi-GB re-uploads.
            try:
                info = await self.refresher.stat(ns, d)
            except BlobNotFoundError:
                raise web.HTTPNotFound(text="blob not found")
            except Exception:
                # "Can't tell" must NOT read as "not there": a transient
                # backend outage would otherwise trigger re-uploads and
                # false LOST verdicts downstream.
                raise web.HTTPBadGateway(text="backend stat failed")
            return web.json_response({"size": info.size})
        return web.json_response({"size": size})

    def _touch(self, d: Digest) -> None:
        """Feed the eviction clock on every read (throttled internally)."""
        if self.cleanup is not None:
            self.cleanup.touch(d)

    async def _download(self, req: web.Request) -> web.StreamResponse:
        await self._brownout_gate()
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        await self._ensure_local(ns, d)
        self._touch(d)
        # One Range-capable streaming path over BOTH storage
        # representations (store/serve.py): the reader opens the flat
        # fd or the chunk manifest atomically, so a chunk-tier
        # conversion racing this request can never 404/500 it. O(1)
        # request memory for any blob size; the delta planner's
        # need-span 206s serve from either representation.
        from kraken_tpu_torch.store.serve import blob_response

        return await blob_response(req, self.store, d)

    async def _metainfo(self, req: web.Request) -> web.Response:
        await self._brownout_gate()
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        # Cached sidecar FIRST, before any in-cache check: during a
        # serve-while-ingest window the metainfo is published (and the
        # torrent seeding from the spool) while the blob is NOT yet in
        # the cache -- agents must be able to start their pull now.
        metainfo = await asyncio.to_thread(self.generator.get_cached, d)
        if metainfo is not None and self.scheduler is not None:
            try:
                # Metainfo fetch precedes a swarm download: make sure we
                # seed (no-op when the spool-backed torrent is live).
                self.scheduler.seed(metainfo, ns)
            except KeyError:
                # Sidecar without bytes or a live torrent (early-publish
                # orphan after a crash): treat as a miss; _ensure_local
                # restores or 404s.
                metainfo = None
        if metainfo is None:
            await self._ensure_local(ns, d)
            metainfo = await self.generator.generate(d)
            if self.scheduler is not None:
                self.scheduler.seed(metainfo, ns)
        self._touch(d)  # metainfo fetch = imminent swarm read
        return web.Response(body=metainfo.serialize())

    async def _delete(self, req: web.Request) -> web.Response:
        d = self._digest(req)
        if self.dedup is not None:
            # Before the blob goes: the sidecar must still be readable for
            # the ledger adjustment.
            await self.dedup.remove(d)
        await asyncio.to_thread(self.store.delete_cache_file, d)
        if self.scheduler is not None:
            # AFTER the unlink: unseeding first would leave a window where
            # an inbound handshake resurrects the control while the blob
            # still exists on disk.
            self.scheduler.unseed(d)
        return web.Response(status=204)

    async def _health(self, req: web.Request) -> web.Response:
        if self.lameduck:
            # Failing health IS the drain broadcast: ring peers' active
            # monitors drop this origin within their fail threshold and
            # re-replication routes around it -- no orchestration hook.
            raise self.drain_unavailable()
        return web.Response(text="ok")

    async def _similar(self, req: web.Request) -> web.Response:
        if self.dedup is None:
            raise web.HTTPNotFound(text="dedup index disabled")
        d = self._digest(req)
        try:
            k = int(req.query.get("k", "10"))
            min_j = float(req.query.get("min_jaccard", "0.05"))
        except ValueError:
            raise web.HTTPBadRequest(text="malformed k/min_jaccard")
        if k <= 0 or not 0.0 <= min_j <= 1.0:
            raise web.HTTPBadRequest(text="k must be >0, min_jaccard in [0,1]")
        try:
            # Ensure this blob is indexed (sync path: cheap when the
            # sidecar exists; chunks+sketches on first touch otherwise).
            await asyncio.to_thread(self.dedup.add_blob_sync, d)
            hits = await asyncio.to_thread(self.dedup.similar, d, k, min_j)
        except KeyError:
            raise web.HTTPNotFound(text="blob not found")
        return web.json_response({"similar": hits})

    async def _dedup_stats(self, req: web.Request) -> web.Response:
        if self.dedup is None:
            raise web.HTTPNotFound(text="dedup index disabled")
        return web.json_response(self.dedup.stats())

    async def _recipe(self, req: web.Request) -> web.Response:
        """The blob's ordered CDC chunk table (core/metainfo.ChunkRecipe),
        derived from the dedup plane's sketch sidecar -- recomputed via
        the ChunkRouter on a sidecar miss. The delta planner's control
        document; gated on ``delta.enabled`` (shipped off) so rollout is
        an explicit origin-side decision."""
        await self._brownout_gate()
        ns = urllib.parse.unquote(req.match_info["ns"])
        d = self._digest(req)
        if self.dedup is None or not self.delta_config.enabled:
            raise web.HTTPNotFound(text="delta recipes disabled")
        served = REGISTRY.counter(
            "origin_recipe_requests_total",
            "Chunk-recipe requests by result (hit = served from the "
            "sketch sidecar, recompute = re-chunked on miss)",
        )
        if failpoints.fire("origin.recipe.miss"):
            # Chaos: a recipe plane that went dark (sidecar store fault)
            # -- agents must degrade to the full pull, never fail it.
            served.inc(result="miss")
            raise web.HTTPNotFound(text="failpoint origin.recipe.miss")
        await self._ensure_local(ns, d)
        self._touch(d)  # a recipe fetch precedes an imminent delta pull
        try:
            recipe, had_sidecar = await asyncio.to_thread(
                self.dedup.recipe_sync, d
            )
        except KeyError:
            # Includes DedupEvictionRace: the blob raced away mid-derive.
            served.inc(result="miss")
            raise web.HTTPNotFound(text="blob not found")
        served.inc(result="hit" if had_sidecar else "recompute")
        return web.Response(
            body=recipe.serialize(), content_type="application/json"
        )
