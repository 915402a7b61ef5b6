"""Startup fsck: reconcile a CAStore's on-disk tree after a crash.

The port's copy of ``kraken_tpu.store.recovery``, the chunk tier's pass
included.

The CAS invariant (a blob's identity IS its SHA-256) makes the store
exactly checkable, but only commit ever verifies it -- a crash can leave
the tree littered with artifacts no request path will ever clean up:

- upload spool files whose client died mid-stream (``upload/<uuid>``);
- partial piece-wise downloads abandoned mid-swarm (``<hex>.part`` and
  the ``.alloc`` staging file);
- metadata tmp files from a ``set_metadata`` interrupted between write
  and rename (``._md_<name>.tmp<pid>.<tid>``);
- sidecars whose data file is gone (deleted under power loss after the
  sidecar rename journaled but before the data unlink did, or vice
  versa);
- data files with no namespace sidecar (partial restore of the cache
  tree): committed bytes invisible to the repair/writeback planes;
- blobs written inside the crash window -- under ``durability: rename``
  a power loss can leave a just-committed blob empty or torn (the
  rename journals before the data hits the platter; castore.py).

``run_fsck`` repairs all of it before any listener binds (assembly
calls it at node start), counting every action on
``fsck_repairs_total{kind}``. A blob that fails content verification is
MOVED to ``quarantine/`` (never deleted -- operators post-mortem;
docs/OPERATIONS.md) and reported unhealable: the offline tool exits 2 so
deploy scripts can gate, and the live origin re-fetches it from ring
replicas via the heal plane (origin/server.py).

Crash-window detection uses a clean-shutdown stamp (``<root>/clean``):
nodes write it with the current time at orderly stop, and every
repairing fsck pass bumps it when it finishes -- so a crash-looping
node re-verifies only the blobs written since its LAST boot, not an
ever-growing window since the last orderly stop. Any data file whose
mtime postdates the stamp was written by a run that did not shut down
cleanly -- exactly the set worth re-hashing at boot without paying a
full-store verify. No stamp at all means the store predates the stamp
plane (or was hand-built): fsck logs, skips verification for THIS pass
(full coverage belongs to the background scrubber, store/scrub.py), and
stamps, so the crash-window clock starts with the first boot.

Failpoint ``store.fsck.orphan`` plants a synthetic orphan sidecar at the
start of a run, so a chaos harness can prove the repair plane executes
inside a real assembled node.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store.castore import CAStore
from kraken_tpu_torch.store.metadata import ChunkManifestMetadata, NamespaceMetadata
from kraken_tpu_torch.utils import failpoints

_log = logging.getLogger("kraken.recovery")

_STAMP_NAME = "clean"

# Exit codes for `kraken-tpu fsck` (CI/deploy gates; docs/OPERATIONS.md).
EXIT_CLEAN = 0
EXIT_REPAIRED = 1
EXIT_UNHEALABLE = 2


def write_clean_shutdown(store: CAStore, now: float | None = None) -> None:
    """Record an orderly shutdown (assembly calls this from node stop).
    Atomic write: a crash DURING the write must not leave a torn stamp
    that reads as a bogus timestamp."""
    path = os.path.join(store.root, _STAMP_NAME)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(repr(time.time() if now is None else now))
    os.replace(tmp, path)


def read_clean_shutdown(store: CAStore) -> float | None:
    """The last clean-shutdown time, or None when the store has never
    been cleanly shut down (first boot, or hand-built tree)."""
    try:
        with open(os.path.join(store.root, _STAMP_NAME)) as f:
            return float(f.read())
    except (FileNotFoundError, ValueError):
        return None


def quarantine_namespace(store: CAStore, hex_: str) -> str:
    """The namespace a quarantined blob was committed under -- its
    sidecar moved to quarantine with the bytes, and the heal plane
    re-fetches under it. Same "default" fallback as origin/server.py."""
    path = os.path.join(
        store.quarantine_dir, f"{hex_}._md_{NamespaceMetadata.name}"
    )
    try:
        with open(path, "rb") as f:
            return NamespaceMetadata.deserialize(f.read()).namespace
    except OSError:
        return "default"


@dataclasses.dataclass
class FsckReport:
    """What one fsck pass did. ``repairs`` counts by kind (mirrors the
    ``fsck_repairs_total{kind}`` labels); ``quarantined`` lists hex
    digests that failed verification and were moved aside --
    unhealable offline, heal-plane work online."""

    repairs: dict[str, int] = dataclasses.field(default_factory=dict)
    quarantined: list[str] = dataclasses.field(default_factory=list)
    verified: int = 0  # blobs re-hashed (crash-window or --verify all)

    def _count(self, kind: str, n: int = 1) -> None:
        if n <= 0:
            return
        self.repairs[kind] = self.repairs.get(kind, 0) + n
        from kraken_tpu_torch.utils.metrics import REGISTRY

        REGISTRY.counter(
            "fsck_repairs_total",
            "Startup fsck repairs by kind (store/recovery.py)",
        ).inc(n, kind=kind)

    @property
    def total_repairs(self) -> int:
        return sum(self.repairs.values())

    @property
    def clean(self) -> bool:
        return not self.repairs and not self.quarantined

    @property
    def exit_code(self) -> int:
        if self.quarantined:
            return EXIT_UNHEALABLE
        if self.repairs:
            return EXIT_REPAIRED
        return EXIT_CLEAN


def _mtime(path: str) -> float | None:
    try:
        return os.path.getmtime(path)
    except OSError:
        return None


def _blob_matches(store: CAStore, d: Digest) -> bool:
    """One shared invariant check (``CAStore.verify_cache_file``): False
    on digest mismatch OR on a read error -- an unreadable blob (failed
    sector, EIO) is at-rest damage exactly like rot; it must quarantine
    and heal, never abort the whole fsck pass (one bad blob turning into
    a node that refuses to boot would invert the point of a recovery
    plane)."""
    return store.verify_cache_file(d)


def run_fsck(
    store: CAStore,
    *,
    upload_ttl_seconds: float = 6 * 3600,
    expect_namespace: bool = False,
    verify: str = "auto",  # auto (crash window) | all | none
    quarantine: bool = True,  # offline report-only runs pass False
    resume: bool = True,  # preserve journaled upload sessions for adoption
) -> FsckReport:
    """One reconciliation pass over ``store``'s tree. Synchronous (runs
    off-loop in assembly; directly in the offline CLI). Safe by
    construction on a quiescent store: assembly runs it BEFORE any
    listener binds, so nothing else is mutating the tree.

    Ages are real filesystem mtimes against the wall clock, never an
    injected ``now`` -- the same contract as the cleanup upload sweep
    (store/cleanup.py): a simulated clock must not unlink live spools.

    ``expect_namespace`` is True on origins only: agents never write
    namespace sidecars, so orphan-data adoption there would mislabel the
    entire store.

    ``resume`` mirrors the node's ``ingest.resume`` config: journaled
    upload sessions (``upload/<uid>.session`` beside their spool) are
    resumable crash state, NOT debris -- a restarted origin re-adopts
    them on the client's next HEAD, so fsck must leave a fresh
    spool+journal pair alone. With resume off the journals are dead
    weight and sweep unconditionally (the spools keep the plain TTL
    rule).
    """
    if verify not in ("auto", "all", "none"):
        raise ValueError(f"unknown verify mode: {verify!r}")
    report = FsckReport()
    now = time.time()

    if failpoints.fire("store.fsck.orphan"):
        # Chaos plane: plant a provably-orphaned sidecar so a live run
        # can assert the repair executed (sweep below removes it).
        fake = "f" * 64
        plant_dir = os.path.join(store.cache_dir, fake[:2], fake[2:4])
        os.makedirs(plant_dir, exist_ok=True)
        with open(os.path.join(plant_dir, f"{fake}._md_fsck_plant"), "wb"):
            pass

    # 1. Stale upload spool files (client died before commit). A LIVE
    # upload keeps a fresh mtime with every PATCH -- only entries idle
    # past the TTL age out, exactly like the periodic cleanup sweep.
    # Spool + session journal are ONE unit: a swept spool takes its
    # journal with it, and a journal whose spool is gone is an orphan
    # (crash between commit's rename and the journal unlink).
    if upload_ttl_seconds > 0 or not resume:
        swept = 0
        journals = 0
        try:
            names = os.listdir(store.upload_dir)
        except FileNotFoundError:
            names = []
        present = set(names)
        for name in names:
            path = os.path.join(store.upload_dir, name)
            if CAStore.SESSION_SUFFIX + ".tmp" in name:
                # Torn journal write (tmp survivor): always debris.
                with contextlib.suppress(OSError):
                    os.unlink(path)
                    journals += 1
                continue
            if name.endswith(CAStore.SESSION_SUFFIX):
                uid = name[: -len(CAStore.SESSION_SUFFIX)]
                if not resume or uid not in present:
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                        journals += 1
                continue  # live journal: only sweeps with its spool below
            age_from = _mtime(path)
            if age_from is None:
                continue
            if upload_ttl_seconds > 0 and now - age_from > upload_ttl_seconds:
                with contextlib.suppress(OSError):
                    os.unlink(path)
                    swept += 1
                with contextlib.suppress(OSError):
                    os.unlink(path + CAStore.SESSION_SUFFIX)
        report._count("stale_spool", swept)
        report._count("upload_session", journals)

    # Digests with a live journaled upload session: their sidecars
    # (early-published metainfo, namespace) may exist BEFORE the blob
    # does -- serve-while-ingest publishes ahead of commit, and a crash
    # in that window leaves sidecars whose data arrives when the client
    # resumes. Not orphans; leave them for the resumed commit.
    live_uploads = store.live_upload_digests() if resume else set()

    stamp = read_clean_shutdown(store)
    if verify == "auto" and stamp is None:
        _log.info(
            "fsck: no clean-shutdown stamp; skipping crash-window verify "
            "(background scrub covers the full store)",
            extra={"store": store.root},
        )

    # 2. Walk the cache tree once. Two sub-passes per directory: debris
    # first (tmp sidecars, stale partials), THEN orphan classification --
    # a piece-status sidecar must see its stale ``.part`` already gone,
    # or it would survive one extra fsck cycle as a fresh orphan.
    for dirpath, _dirnames, filenames in os.walk(store.cache_dir):
        present = set(filenames)
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)

            # 2a. metadata tmp files: set_metadata writes tmp+rename; a
            # tmp survivor means the writer died mid-write. fsck runs on
            # a quiescent store, so every one is a crash leftover.
            if "._md_" in name and ".tmp" in name.rsplit("._md_", 1)[1]:
                with contextlib.suppress(OSError):
                    os.unlink(path)
                    report._count("tmp_sidecar")
                present.discard(name)
                continue

            # 2b. partial-download staging/debris past TTL. ``.part``
            # carries resumable swarm state (piece bitfield sidecar), so
            # only entries idle past the TTL go; ``.alloc`` is a torn
            # allocate_partial_file, same rule.
            if name.endswith((".part", ".alloc")):
                age_from = _mtime(path)
                if (
                    upload_ttl_seconds > 0
                    and age_from is not None
                    and now - age_from > upload_ttl_seconds
                ):
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                        report._count("stale_partial")
                        present.discard(name)

        for name in sorted(present):
            path = os.path.join(dirpath, name)

            # 2c. orphan sidecars: data file gone AND no resumable
            # partial beside it. (A sidecar next to a live ``.part`` is
            # the piece bitfield -- crash-resume depends on it.) A
            # chunk-tier MANIFEST sidecar counts as the data file: a
            # manifest-backed blob has no 64-hex flat file by design,
            # and deleting its sidecars would orphan the blob's chunks.
            if "._md_" in name:
                base = name.split("._md_", 1)[0]
                manifest = f"{base}._md_{ChunkManifestMetadata.name}"
                if (
                    base not in present
                    and base not in live_uploads
                    and f"{base}.part" not in present
                    and not (
                        store.chunkstore is not None
                        and manifest in present
                    )
                ):
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                        report._count("orphan_sidecar")
                continue

            if name.endswith((".part", ".alloc")):
                continue  # live partial: resumable, leave alone

            if len(name) != 64:
                continue  # not a blob (unknown debris: leave for humans)
            try:
                d = Digest.from_hex(name)
            except ValueError:
                continue  # 64 chars but not hex: debris, not a blob

            # 2d. orphan data: committed bytes with no namespace sidecar
            # are invisible to the repair/writeback planes. Re-adopt
            # under the default namespace (the same fallback
            # origin/server.py uses) so replication can see them again.
            if (
                expect_namespace
                and store.get_metadata(d, NamespaceMetadata) is None
            ):
                store.set_metadata(d, NamespaceMetadata("default"))
                report._count("adopted")

            # 2e. crash-window content verify: only blobs whose mtime
            # postdates the last clean shutdown can be torn.
            check = verify == "all" or (
                verify == "auto"
                and stamp is not None
                and (_mtime(path) or 0.0) > stamp
            )
            if check:
                report.verified += 1
                if not _blob_matches(store, d):
                    if quarantine:
                        # A move that itself fails (same dying disk) must
                        # not abort the pass: the blob is still counted
                        # unhealable, so the exit code/report alert.
                        with contextlib.suppress(OSError):
                            store.quarantine_cache_file(d)
                    report._count("quarantined")
                    report.quarantined.append(d.hex)
                    from kraken_tpu_torch.utils.metrics import REGISTRY

                    REGISTRY.counter(
                        "scrub_corruptions_total",
                        "Blobs that failed at-rest content verification",
                    ).inc(source="fsck")

    # 3. Chunk tier (store/chunkstore.py, when attached): torn chunk-
    # write staging files, a dual-state repair (flat file AND manifest:
    # a crash between convert_to_chunks' manifest write and flat unlink
    # -- the self-contained flat copy wins, the manifest's refs
    # release), refcount rebuild from the authoritative manifest set (a
    # torn journal heals here), orphan-chunk reap (zero-ref after
    # rebuild = garbage no manifest can reach), and crash-window verify
    # of manifest-backed blobs -- a corrupt chunk is QUARANTINED (never
    # deleted) and every blob referencing it reports unhealable so the
    # heal plane re-fetches and re-chunks the verified bytes.
    if store.chunkstore is not None:
        cs = store.chunkstore
        report._count("chunk_tmp", cs.sweep_tmp())
        manifests: list[tuple] = []
        chunked: list[tuple[Digest, object]] = []
        for d in store.list_cache_digests():
            try:
                md = store.get_metadata(d, ChunkManifestMetadata)
            except ValueError:
                if os.path.exists(store.cache_path(d)):
                    # Rotted manifest BESIDE a flat file (power loss
                    # mid-convert): the intact flat bytes are
                    # authoritative -- drop only the bad sidecar, same
                    # verdict as the dual-state repair below.
                    with contextlib.suppress(OSError):
                        os.unlink(store._manifest_path(d))
                    report._count("chunk_dual_state")
                    continue
                # Rotted/truncated manifest with no flat file: the blob
                # has no readable representation. Quarantine the
                # evidence and report unhealable -- one bad sidecar must
                # not abort the whole pass (the recovery plane's first
                # rule). Its chunks go orphan in the rebuild below and
                # reap there.
                if quarantine:
                    with contextlib.suppress(OSError):
                        store.quarantine_cache_file(d)
                report._count("quarantined")
                report.quarantined.append(d.hex)
                continue
            if md is None:
                continue
            if os.path.exists(store.cache_path(d)):
                # Dual state: the flat bytes are authoritative (they
                # were never unlinked); drop the manifest + its refs.
                cs.release_blob(md.fps, md.sizes)
                with contextlib.suppress(OSError):
                    os.unlink(store._manifest_path(d))
                report._count("chunk_dual_state")
                continue
            manifests.append((md.fps, md.sizes))
            chunked.append((d, md))
        # Orphans are chunk files the JOURNAL never knew about (a crash
        # between chunk rename and journal fsync): discovered by the
        # rebuild's disk walk. Journal-tracked zero-ref chunks are NOT
        # orphans -- they are normal deletes awaiting the budgeted GC,
        # and a healthy store must not read as "repaired" for having
        # them.
        known = cs.known_chunks()
        report._count("chunk_refs_rebuilt", cs.rebuild_refs(manifests))
        orphans = [k for k in cs.zero_ref_chunks() if k not in known]
        for fp, size in orphans:
            cs.gc_reap_one(fp, size)
        report._count("orphan_chunk", len(orphans))
        for d, md in chunked:
            check = verify == "all" or (
                verify == "auto"
                and stamp is not None
                and (_mtime(store._manifest_path(d)) or 0.0) > stamp
            )
            if not check:
                continue
            report.verified += 1
            if _blob_matches(store, d):
                continue
            for fp, _off, size in md.chunks():
                if not cs.verify_chunk(fp, size):
                    with contextlib.suppress(OSError):
                        cs.quarantine_chunk(fp, size)
            if quarantine:
                with contextlib.suppress(OSError):
                    store.quarantine_cache_file(d)
            report._count("quarantined")
            report.quarantined.append(d.hex)
            from kraken_tpu_torch.utils.metrics import REGISTRY

            REGISTRY.counter(
                "scrub_corruptions_total",
                "Blobs that failed at-rest content verification",
            ).inc(source="fsck")

    # Bump the stamp after a repairing pass: the window just examined is
    # clean (or quarantined) as of now. Without this, (a) a crash-LOOPING
    # node re-verifies an ever-growing window against a weeks-old stamp
    # on every boot, and (b) a node that crashes before its FIRST orderly
    # stop never gets a reference point at all -- every subsequent crash
    # window goes unchecked forever. Report-only (quarantine=False) and
    # verify="none" runs examined nothing, so they must not claim to.
    if quarantine and verify != "none":
        write_clean_shutdown(store)
    if not report.clean:
        _log.warning(
            "fsck repaired the store tree",
            extra={
                "store": store.root,
                "repairs": report.repairs,
                "quarantined": report.quarantined,
            },
        )
    return report
