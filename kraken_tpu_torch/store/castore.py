"""Content-addressable file store with an upload -> cache state transition.

The port's copy of ``kraken_tpu.store.castore``. Behavior mirrored from
uber/kraken ``lib/store`` (``CAStore``: upload dir, atomic rename into a
sharded cache dir, per-file metadata) -- upstream path, unverified;
SURVEY.md SS2.3.

Layout (the tree the reference keeps, so either package opens a store the
other wrote):

    <root>/upload/<uuid>                 in-flight uploads (random names)
    <root>/cache/<hex[:2]>/<hex[2:4]>/<hex>   committed blobs, sharded
    <data_path>._md_<name>               typed metadata sidecars
    <root>/upload/<uuid>.session         resumable-upload journals (JSON)
    <data_path>.part                     piece-wise downloads in progress
    <root>/quarantine/<hex>              corrupt blobs moved aside (+ sidecars)

Invariants:

- a path under ``cache/`` is immutable once present (CAS semantics); commit
  is an atomic ``os.replace`` so readers never observe partial blobs;
- every mutation of metadata goes through atomic tmp+rename as well;
- digests are verified on commit unless the caller already streamed through
  a :class:`~kraken_tpu_torch.core.digest.Digester`.

Thread-safety: a single process-wide lock guards directory-level races
(concurrent commit of the same digest); data-plane reads/writes are lock-free.

With a chunk store attached (``attach_chunkstore``), a blob may instead
live in the chunk tier: a ``_md_chunk_manifest`` sidecar and no flat data
file, its bytes in ``<root>/chunks/`` (``store/chunkstore.py``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid as uuidlib
from typing import BinaryIO, Iterator, Optional, Type, TypeVar

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store.metadata import ChunkManifestMetadata, Metadata
from kraken_tpu_torch.utils import failpoints

M = TypeVar("M", bound=Metadata)

_CHUNK = 4 * 1024 * 1024


class StoreError(Exception):
    pass


class UploadNotFoundError(StoreError):
    pass


class FileExistsInCacheError(StoreError):
    """Commit target already cached -- callers treat as success (CAS)."""


class DigestMismatchError(StoreError):
    pass


class CAStore:
    """Content-addressable store rooted at a directory."""

    def __init__(self, root: str, durability: str = "rename"):
        """``durability`` states the crash contract (docs/OPERATIONS.md):

        - ``"rename"`` (default): atomic rename only. Process crash never
          observes partial blobs; on POWER LOSS a just-committed blob or
          sidecar can be empty/partial (the rename may be journaled
          before the data hits the platter).
        - ``"fsync"``: fsync the file before rename and the directory
          after, on every blob commit and sidecar write. Power-loss
          durable; costs one fdatasync+dirsync per commit (measured in
          bench_ingest.py).
        """
        if durability not in ("rename", "fsync"):
            raise ValueError(f"unknown durability mode: {durability!r}")
        self.root = root
        self.durability = durability
        self.upload_dir = os.path.join(root, "upload")
        self.cache_dir = os.path.join(root, "cache")
        # Corrupt blobs are MOVED here, never deleted: an operator can
        # post-mortem the damaged bytes (store/scrub.py, store/recovery.py).
        # Deliberately outside cache/: quarantined files are invisible to
        # list_cache_digests and eviction, but still counted by
        # disk_usage_bytes (they occupy real disk under the watermarks).
        self.quarantine_dir = os.path.join(root, "quarantine")
        os.makedirs(self.upload_dir, exist_ok=True)
        os.makedirs(self.cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        # Content-addressed chunk tier (store/chunkstore.py), attached by
        # assembly when the ``chunkstore:`` config enables it OR when the
        # tier directory already holds chunks (a node restarted with the
        # knob turned off must keep serving its manifest-backed blobs).
        # None = every blob is a flat file, exactly the pre-tier store.
        self.chunkstore = None

    def attach_chunkstore(self, chunkstore) -> None:
        self.chunkstore = chunkstore

    def _commit_file(self, src: str, dst: str) -> None:
        """Move ``src`` into place at ``dst`` under the durability mode."""
        if failpoints.fire("castore.commit"):
            # Full disk surfacing at the rename/fsync boundary.
            import errno

            raise OSError(errno.ENOSPC, "failpoint castore.commit", dst)
        if self.durability == "fsync":
            fd = os.open(src, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(src, dst)
        if self.durability == "fsync":
            dfd = os.open(os.path.dirname(dst), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    # -- paths -------------------------------------------------------------

    def cache_path(self, d: Digest) -> str:
        return os.path.join(self.cache_dir, d.hex[:2], d.hex[2:4], d.hex)

    def _upload_path(self, uid: str) -> str:
        return os.path.join(self.upload_dir, uid)

    # -- upload flow (origin chunked upload; proxy push) -------------------

    def create_upload(self) -> str:
        """Start an upload; returns its id."""
        uid = uuidlib.uuid4().hex
        with open(self._upload_path(uid), "wb"):
            pass
        return uid

    def upload_path(self, uid: str) -> str:
        """Filesystem path of an in-progress upload, for file-based
        writers that stream straight into the upload area (e.g. backend
        ``download_to_file``) before an atomic verified commit."""
        return self._upload_path(uid)

    def upload_exists(self, uid: str) -> bool:
        return os.path.exists(self._upload_path(uid))

    def write_upload_chunk(self, uid: str, offset: int, data: bytes) -> None:
        path = self._upload_path(uid)
        if not os.path.exists(path):
            raise UploadNotFoundError(uid)
        if failpoints.fire("castore.write"):
            import errno

            raise OSError(errno.ENOSPC, "failpoint castore.write", path)
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(data)

    def open_upload_file(self, uid: str) -> BinaryIO:
        """Writable handle on an in-progress upload (callers that stream
        many chunks hold one handle instead of re-opening per chunk)."""
        path = self._upload_path(uid)
        if not os.path.exists(path):
            raise UploadNotFoundError(uid)
        return open(path, "r+b")

    def upload_size(self, uid: str) -> int:
        path = self._upload_path(uid)
        if not os.path.exists(path):
            raise UploadNotFoundError(uid)
        return os.path.getsize(path)

    def commit_upload(
        self,
        uid: str,
        d: Digest,
        verify: bool = True,
        precomputed: Optional[Digest] = None,
    ) -> None:
        """Atomically move an upload into the cache under its digest.

        With ``verify`` the content is re-hashed and must match ``d``;
        ``precomputed`` (a digest the CALLER computed over the streamed
        bytes, e.g. the origin's running upload hash) substitutes for the
        re-read -- committing a 1 GiB blob then costs a rename, not a
        second full read+hash pass. Committing a digest that is already
        cached discards the upload and raises
        :class:`FileExistsInCacheError` (callers usually swallow it).
        """
        src = self._upload_path(uid)
        if not os.path.exists(src):
            self.delete_upload_session(uid)
            raise UploadNotFoundError(uid)
        if verify:
            if precomputed is not None:
                actual = precomputed
            else:
                with open(src, "rb") as f:
                    actual = Digest.from_reader(f)
            if actual != d:
                os.unlink(src)
                self.delete_upload_session(uid)
                raise DigestMismatchError(f"expected {d}, got {actual}")
        dst = self.cache_path(d)
        with self._lock:
            # in_cache, not a flat-path check: committing a flat copy
            # over a chunk-BACKED blob would create the dual state fsck
            # exists to repair.
            if os.path.exists(dst) or self.is_chunked(d):
                os.unlink(src)
                self.delete_upload_session(uid)
                raise FileExistsInCacheError(str(d))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            self._commit_file(src, dst)
        # Journal last: a crash between rename and this unlink leaves an
        # orphan journal (spool gone), which fsck/cleanup sweep as such.
        self.delete_upload_session(uid)

    def abort_upload(self, uid: str) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self._upload_path(uid))
        self.delete_upload_session(uid)

    # -- resumable-upload session journals ---------------------------------
    #
    # ``upload/<uid>.session`` is a tiny JSON sidecar the origin writes at
    # every durable flush of a chunked upload: the byte offset the spool
    # provably holds, the optimistic stream piece length, and the hex
    # prefix of piece digests already hashed behind that offset. After a
    # crash (or a mid-stream tracker invalidation) the origin re-adopts
    # the session from this journal instead of forcing a from-zero
    # retry -- see origin/server.py ``_adopt_session_sync`` and the
    # OPERATIONS.md "Resumable ingest & serve-while-ingest" runbook.

    SESSION_SUFFIX = ".session"

    def upload_session_path(self, uid: str) -> str:
        return self._upload_path(uid) + self.SESSION_SUFFIX

    def write_upload_session(self, uid: str, doc: dict) -> None:
        """Atomically persist the resumable-upload journal for ``uid``.

        Plain tmp+rename (durability-aware), deliberately NOT through
        ``_commit_file``: the ``castore.commit`` failpoint models blob
        commits, and arming it must not also tear journal writes."""
        import json

        path = self.upload_session_path(uid)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(json.dumps(doc).encode())
            if self.durability == "fsync":
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def read_upload_session(self, uid: str) -> Optional[dict]:
        """The journal doc, or None when absent or torn (a torn journal
        means the session is unadoptable, never an error)."""
        import json

        try:
            with open(self.upload_session_path(uid), "rb") as f:
                doc = json.loads(f.read())
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def delete_upload_session(self, uid: str) -> None:
        with contextlib.suppress(OSError):
            os.unlink(self.upload_session_path(uid))

    def list_upload_sessions(self) -> list[str]:
        """uids that have a session journal (spool may or may not exist)."""
        try:
            names = os.listdir(self.upload_dir)
        except FileNotFoundError:
            return []
        n = len(self.SESSION_SUFFIX)
        return sorted(
            name[:-n] for name in names
            if name.endswith(self.SESSION_SUFFIX) and ".tmp" not in name
        )

    def live_upload_digests(self) -> set[str]:
        """Digest hexes with a live journaled upload session -- the
        still-arriving-tail guard consulted by scrub and fsck so an
        in-flight blob (or its early-published metainfo sidecar) is
        never quarantined or swept mid-ingest."""
        out: set[str] = set()
        for uid in self.list_upload_sessions():
            doc = self.read_upload_session(uid)
            if doc and isinstance(doc.get("digest"), str):
                out.add(doc["digest"])
        return out

    def truncate_upload(self, uid: str, size: int) -> None:
        """Cut the spool back to ``size`` bytes (session adoption drops
        bytes beyond the journaled durable offset -- they were written
        but never journaled, so their hash state is unknown)."""
        path = self._upload_path(uid)
        if not os.path.exists(path):
            raise UploadNotFoundError(uid)
        os.truncate(path, size)

    # -- direct cache writes (blobrefresh; torrent allocation) -------------

    def create_cache_file(self, d: Digest, chunks: Iterator[bytes], verify: bool = True) -> None:
        """Stream ``chunks`` into the cache under ``d`` (no-op if cached)."""
        if self.in_cache(d):
            return
        uid = self.create_upload()
        path = self._upload_path(uid)
        with open(path, "wb") as f:
            for c in chunks:
                f.write(c)
        try:
            self.commit_upload(uid, d, verify=verify)
        except FileExistsInCacheError:
            pass

    def partial_path(self, d: Digest) -> str:
        """Where an in-progress piece-wise download lives. Only a completed,
        verified blob ever occupies ``cache_path`` -- ``in_cache`` therefore
        means *committed*, and cleanup never sees partials."""
        return self.cache_path(d) + ".part"

    def allocate_partial_file(self, d: Digest, length: int) -> str:
        """Pre-allocate the partial file for piece-wise download (resumable:
        piece bitfield metadata persists beside it). Returns the path."""
        dst = self.partial_path(d)
        with self._lock:
            if not os.path.exists(dst):
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                tmp = dst + ".alloc"
                with open(tmp, "wb") as f:
                    f.truncate(length)
                os.replace(tmp, dst)
        return dst

    def commit_partial_file(self, d: Digest) -> None:
        """Atomically promote a completed partial into the cache."""
        with self._lock:
            if self.is_chunked(d):
                # Already committed via the chunk tier: drop the partial
                # (same benign race as a flat copy landing first).
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(self.partial_path(d))
                return
            if not os.path.exists(self.cache_path(d)):
                os.makedirs(os.path.dirname(self.cache_path(d)), exist_ok=True)
                self._commit_file(self.partial_path(d), self.cache_path(d))
            else:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(self.partial_path(d))

    def has_partial(self, d: Digest) -> bool:
        return os.path.exists(self.partial_path(d))

    def delete_partial_file(self, d: Digest) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.partial_path(d))

    # -- chunk-tier state --------------------------------------------------

    def _manifest_path(self, d: Digest) -> str:
        return self._md_path(self.cache_path(d), ChunkManifestMetadata.name)

    def manifest(self, d: Digest):
        """The blob's chunk manifest, or None when it is stored flat OR
        the sidecar is unreadable/rotted -- a corrupt manifest must read
        as 'no healthy chunk-backed copy' (scrub quarantines it), never
        abort the caller."""
        if self.chunkstore is None:
            return None
        try:
            return self.get_metadata(d, ChunkManifestMetadata)
        except ValueError:
            return None

    def is_chunked(self, d: Digest) -> bool:
        """True when the blob's bytes live in the chunk tier (manifest
        sidecar present, no flat data file). A blob is EITHER flat or
        chunked -- convert_to_chunks/materialize_flat move between the
        states atomically enough that readers always find one."""
        return (
            self.chunkstore is not None
            and not os.path.exists(self.cache_path(d))
            and os.path.exists(self._manifest_path(d))
        )

    # -- reads -------------------------------------------------------------

    def in_cache(self, d: Digest) -> bool:
        # in_cache == committed: a flat file at the cache path, or a
        # chunk-tier manifest (partials live at .part either way).
        return os.path.exists(self.cache_path(d)) or self.is_chunked(d)

    def cache_size(self, d: Digest) -> int:
        try:
            return os.path.getsize(self.cache_path(d))
        except FileNotFoundError:
            md = self.manifest(d) if self.is_chunked(d) else None
            if md is not None:
                return md.length
            raise KeyError(str(d)) from None

    def open_cache_file(self, d: Digest) -> BinaryIO:
        """Readable handle on a committed blob: the flat file, or a
        file-like composed view over its chunks -- sequential consumers
        (scrub, digest verify, metainfo generation, backend writeback)
        need no tier awareness."""
        try:
            return open(self.cache_path(d), "rb")
        except FileNotFoundError:
            reader = self._chunk_reader(d)
            if reader is not None:
                from kraken_tpu_torch.store.chunkstore import ChunkBackedIO

                return ChunkBackedIO(reader)  # type: ignore[return-value]
            raise KeyError(str(d)) from None

    def _chunk_reader(self, d: Digest):
        if not self.is_chunked(d):
            return None
        md = self.manifest(d)
        if md is None:
            return None
        from kraken_tpu_torch.store.chunkstore import ChunkReader

        return ChunkReader(self.chunkstore, md.fps, md.sizes)

    def open_cache_reader(self, d: Digest):
        """Positional-read handle (``.pread(n, off)``/``.length``/
        ``.close()``) over a committed blob, flat or chunked -- the one
        interface piece serves and delta base copies use so both storage
        representations share a code path. KeyError if absent. Flat
        readers expose ``fileno()``; chunk-backed ones raise
        ``io.UnsupportedOperation`` there (no single fd exists)."""
        from kraken_tpu_torch.store.chunkstore import FlatReader

        try:
            fd = os.open(self.cache_path(d), os.O_RDONLY)
        except FileNotFoundError:
            reader = self._chunk_reader(d)
            if reader is not None:
                return reader
            raise KeyError(str(d)) from None
        return FlatReader(fd, os.fstat(fd).st_size)

    def open_cache_fd(self, d: Digest) -> int:
        """Raw ``O_RDONLY`` fd on a cached blob (KeyError if absent).
        Callers own the fd (``os.close``); positional reads (``os.pread``)
        from worker threads then need no shared file offset -- the delta
        planner's base-chunk copies use this. CAS immutability means the
        fd stays valid content even if the blob is evicted after open."""
        try:
            return os.open(self.cache_path(d), os.O_RDONLY)
        except FileNotFoundError:
            raise KeyError(str(d)) from None

    def read_cache_file(self, d: Digest) -> bytes:
        with self.open_cache_file(d) as f:
            return f.read()

    def stream_cache_file(self, d: Digest) -> Iterator[bytes]:
        with self.open_cache_file(d) as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    return
                yield chunk

    def list_cache_digests(self) -> list[Digest]:
        out = set()
        manifest_suffix = f"._md_{ChunkManifestMetadata.name}"
        for dirpath, _dirnames, filenames in os.walk(self.cache_dir):
            for name in filenames:
                if len(name) == 64 and "._md_" not in name:
                    out.add(name)
                elif self.chunkstore is not None and name.endswith(
                    manifest_suffix
                ):
                    # Chunk-backed blobs have no 64-hex data file; their
                    # manifest sidecar is the committed marker.
                    base = name[: -len(manifest_suffix)]
                    if len(base) == 64:
                        out.add(base)
        return sorted(Digest.from_hex(h) for h in out)

    def _release_manifest_refs(self, d: Digest) -> None:
        """Drop the chunk references a blob's manifest holds -- called
        with the manifest sidecar still readable, BEFORE it is unlinked
        or moved (the chunk-tier mirror of the dedup on_evict contract)."""
        if self.chunkstore is None:
            return
        try:
            md = self.get_metadata(d, ChunkManifestMetadata)
        except ValueError:
            return
        if md is not None:
            self.chunkstore.release_blob(md.fps, md.sizes)

    def delete_cache_file(self, d: Digest) -> None:
        path = self.cache_path(d)
        with self._lock:
            self._release_manifest_refs(d)
            with contextlib.suppress(FileNotFoundError):
                os.unlink(path)
            for md in self._metadata_paths(path):
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(md)

    # -- quarantine (self-healing plane: scrub + fsck) ---------------------

    def quarantine_path(self, d: Digest) -> str:
        return os.path.join(self.quarantine_dir, d.hex)

    def quarantine_cache_file(self, d: Digest) -> Optional[str]:
        """Move a corrupt blob and its metadata sidecars into
        ``quarantine/`` -- NEVER silent deletion: operators post-mortem
        the damaged bytes (docs/OPERATIONS.md runbook). The move drops the
        blob from the cache tree, so ``in_cache`` turns False and every
        sidecar-derived state (piece status, torrent meta, dedup sketch)
        goes with it. Returns the quarantine path, or None when the blob
        raced away (evicted/deleted) before the move. Re-quarantining the
        same digest overwrites the previous capture -- same claimed
        content, and the newest damage is the one worth keeping."""
        src = self.cache_path(d)
        with self._lock:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            dst = self.quarantine_path(d)
            chunked = self.is_chunked(d)
            if chunked:
                # No flat data file to move: the manifest sidecar IS the
                # blob's cache-tree presence. Release its chunk refs
                # (the corrupt chunk itself was quarantined separately
                # by scrub/fsck), then move every sidecar -- in_cache
                # flips False and the heal plane restores a flat copy.
                self._release_manifest_refs(d)
            else:
                try:
                    os.replace(src, dst)
                except FileNotFoundError:
                    return None
            moved_manifest = None
            for md in self._metadata_paths(src):
                with contextlib.suppress(FileNotFoundError):
                    q = os.path.join(
                        self.quarantine_dir, os.path.basename(md)
                    )
                    os.replace(md, q)
                    if md.endswith(f"._md_{ChunkManifestMetadata.name}"):
                        moved_manifest = q
            if chunked:
                return moved_manifest
            return dst

    def verify_cache_file(self, d: Digest) -> bool:
        """True iff the cached bytes re-hash to ``d`` -- the ONE place
        the CAS verification invariant lives for at-rest checks (fsck
        crash-window verify, heal's cached-copy check). Missing or
        unreadable (EIO on a failed sector) both read as 'not a healthy
        copy': callers treat unreadable as at-rest damage, never as an
        excuse to abort or to trust the bytes."""
        try:
            with self.open_cache_file(d) as f:
                return Digest.from_reader(f) == d
        except (OSError, KeyError):
            return False

    def list_quarantined(self) -> list[str]:
        """Hex digests currently held in quarantine (operator surface)."""
        try:
            names = os.listdir(self.quarantine_dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names if len(n) == 64 and "._md_" not in n)

    # -- metadata ----------------------------------------------------------

    def _md_path(self, data_path: str, name: str) -> str:
        return f"{data_path}._md_{name}"

    def _metadata_paths(self, data_path: str) -> list[str]:
        d = os.path.dirname(data_path)
        base = os.path.basename(data_path)
        if not os.path.isdir(d):
            return []
        return [
            os.path.join(d, n)
            for n in os.listdir(d)
            if n.startswith(base + "._md_")
        ]

    def set_metadata(self, d: Digest, md: Metadata) -> None:
        path = self._md_path(self.cache_path(d), md.name)
        # Sidecars normally follow their data file, whose commit creates
        # the shard dir -- but serve-while-ingest publishes the metainfo
        # sidecar BEFORE the blob lands, so the dir may not exist yet.
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(md.serialize())
        self._commit_file(tmp, path)

    def get_metadata(self, d: Digest, cls: Type[M]) -> Optional[M]:
        path = self._md_path(self.cache_path(d), cls.name)
        try:
            with open(path, "rb") as f:
                return cls.deserialize(f.read())  # type: ignore[return-value]
        except FileNotFoundError:
            return None

    def delete_metadata(self, d: Digest, cls: Type[Metadata]) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self._md_path(self.cache_path(d), cls.name))

    # -- chunk-tier conversion ---------------------------------------------

    def convert_to_chunks(self, d: Digest, fps, sizes) -> dict | None:
        """Move a committed FLAT blob into the chunk tier: admit its
        chunks (each verified against the recipe fp as it is read -- a
        recipe that disagrees with the bytes aborts the conversion and
        the blob stays flat), write the manifest sidecar, then unlink
        the flat file. Readers racing the unlink are safe: an fd opened
        before it keeps the immutable bytes, and one opened after finds
        the manifest. Returns ``{"new_bytes", "dup_bytes", "length"}``
        or None when the blob is absent/already chunked/tier detached."""
        from kraken_tpu_torch.store.chunkstore import ChunkCorruptError

        if self.chunkstore is None or self.is_chunked(d):
            return None
        path = self.cache_path(d)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            length = os.fstat(fd).st_size
            if length != sum(int(s) for s in sizes):
                # Stale recipe vs the committed bytes: not convertible.
                return None

            def read_chunk(_i: int, off: int, size: int) -> bytes:
                return os.pread(fd, size, off)

            try:
                new_bytes, dup_bytes = self.chunkstore.add_blob(
                    fps, sizes, read_chunk
                )
            except ChunkCorruptError:
                # The recipe and the flat bytes disagree (stale sidecar,
                # at-rest rot the recipe predates): keep the flat file
                # -- it is still the verified CAS copy; scrub judges it.
                return None
            # Manifest write + flat unlink under the store lock, with a
            # liveness re-check: delete_cache_file/eviction holds the
            # same lock, so a delete racing this conversion either runs
            # first (we see the flat file gone -> roll back the refs,
            # no manifest is ever written for a dead blob) or runs
            # after (it finds the manifest and releases the refs).
            # Within the lock, manifest BEFORE unlink: a crash between
            # the two leaves a dual-state blob fsck resolves (flat
            # wins, refs released); the reverse order would strand
            # refcounted chunks with no readable blob.
            with self._lock:
                if not os.path.exists(path):
                    self.chunkstore.release_blob(fps, sizes)
                    return None
                self.set_metadata(d, ChunkManifestMetadata(fps, sizes))
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
        finally:
            os.close(fd)
        return {
            "new_bytes": new_bytes, "dup_bytes": dup_bytes, "length": length,
        }

    def export_to_file(self, d: Digest, dst: str) -> None:
        """Write a blob's bytes (flat or chunked) to ``dst`` -- the
        materialize-to-flat escape hatch for consumers that need a real
        file path (backend multipart writeback, sendfile serves)."""
        with self.open_cache_file(d) as f, open(dst, "wb") as out:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                out.write(chunk)

    def materialize_flat(self, d: Digest) -> bool:
        """Convert a chunk-backed blob BACK to a flat file (tmp in the
        upload area, atomic rename, manifest dropped, chunk refs
        released). The escape hatch for paths that must hand a filesystem
        path to the kernel (shardpool sendfile). Returns True when the
        blob is flat afterwards."""
        if not self.is_chunked(d):
            return os.path.exists(self.cache_path(d))
        uid = self.create_upload()
        tmp = self._upload_path(uid)
        try:
            self.export_to_file(d, tmp)
            with self._lock:
                if os.path.exists(self.cache_path(d)):
                    return True  # raced: someone else materialized
                self._commit_file(tmp, self.cache_path(d))
                self._release_manifest_refs(d)
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(self._manifest_path(d))
            return True
        except OSError:
            return False
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)

    def evictable_bytes(self, d: Digest) -> int:
        """What evicting this blob would actually free: the flat size,
        or -- chunk-backed -- only the bytes no OTHER manifest
        references (store/chunkstore.py unique_bytes). The watermark
        evictor's chunk-aware accounting: a delta base sharing most of
        its chunks frees almost nothing, so evicting it buys no headroom
        and the evictor can afford to keep it."""
        try:
            return os.path.getsize(self.cache_path(d))
        except FileNotFoundError:
            pass
        md = self.manifest(d)
        if md is None or self.chunkstore is None:
            raise KeyError(str(d))
        return self.chunkstore.unique_bytes(md.fps, md.sizes)

    # -- maintenance -------------------------------------------------------

    def disk_usage_bytes(self) -> int:
        """Bytes the store holds on disk: the cache tree PLUS quarantine
        PLUS the chunk tier. Quarantined blobs are invisible to eviction
        (they are evidence, cleaned by operators), but they are real
        disk -- excluding them would let watermark math believe there is
        headroom while the volume fills toward ENOSPC. Same rule for the
        chunk tier: a tier the evictor can't see can fill the volume
        behind its back."""
        total = 0
        for root in (self.cache_dir, self.quarantine_dir):
            for dirpath, _dirnames, filenames in os.walk(root):
                for name in filenames:
                    with contextlib.suppress(FileNotFoundError):
                        total += os.path.getsize(os.path.join(dirpath, name))
        if self.chunkstore is not None:
            total += self.chunkstore.stored_bytes()
        return total
