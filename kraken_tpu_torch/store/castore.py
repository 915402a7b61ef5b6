"""Content-addressable file store with an upload -> cache state transition.

Layout (the same tree ``kraken_tpu.store.castore`` keeps, so either package
opens a store the other wrote):

    <root>/upload/<uuid>                 in-flight uploads (random names)
    <root>/cache/<hex[:2]>/<hex[2:4]>/<hex>   committed blobs, sharded
    <data_path>._md_<name>               typed metadata sidecars
    <data_path>.part                     piece-wise downloads in progress

Invariants:

- a path under ``cache/`` is immutable once present (CAS semantics); commit
  is an atomic ``os.replace`` so readers never observe partial blobs;
- every mutation of metadata goes through atomic tmp+rename as well
  (process-crash safe; no fsync: a power loss can leave a just-renamed
  file empty, as ``kraken_tpu``'s default ``durability="rename"``);
- digests are verified on commit unless the caller already streamed through
  a :class:`~kraken_tpu_torch.core.digest.Digester`.

Only the flat-file tier is ported (with the listing and deletion the dedup
plane needs); the chunk tier, upload sessions, quarantine and the ``fsync``
durability mode wait for the slices that use them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid as uuidlib
from typing import BinaryIO, Optional, Type, TypeVar

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.store.metadata import Metadata

M = TypeVar("M", bound=Metadata)


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

    def __init__(self, root: str):
        self.root = root
        self.upload_dir = os.path.join(root, "upload")
        self.cache_dir = os.path.join(root, "cache")
        os.makedirs(self.upload_dir, exist_ok=True)
        os.makedirs(self.cache_dir, exist_ok=True)
        self._lock = threading.Lock()

    # -- paths -------------------------------------------------------------

    def cache_path(self, d: Digest) -> str:
        return os.path.join(self.cache_dir, d.hex[:2], d.hex[2:4], d.hex)

    def _upload_path(self, uid: str) -> str:
        return os.path.join(self.upload_dir, uid)

    # -- upload flow -------------------------------------------------------

    def create_upload(self) -> str:
        """Start an upload; returns its id."""
        uid = uuidlib.uuid4().hex
        with open(self._upload_path(uid), "wb"):
            pass
        return uid

    def write_upload_chunk(self, uid: str, offset: int, data: bytes) -> None:
        path = self._upload_path(uid)
        if not os.path.exists(path):
            raise UploadNotFoundError(uid)
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(data)

    def commit_upload(
        self,
        uid: str,
        d: Digest,
        verify: bool = True,
        precomputed: Optional[Digest] = None,
    ) -> None:
        """Atomically move an upload into the cache under its digest.

        With ``verify`` the content is re-hashed and must match ``d``;
        ``precomputed`` (a digest the caller computed over the streamed
        bytes) substitutes for the re-read. Committing a digest that is
        already cached discards the upload and raises
        :class:`FileExistsInCacheError` (callers usually swallow it).
        """
        src = self._upload_path(uid)
        if not os.path.exists(src):
            raise UploadNotFoundError(uid)
        if verify:
            if precomputed is not None:
                actual = precomputed
            else:
                with open(src, "rb") as f:
                    actual = Digest.from_reader(f)
            if actual != d:
                os.unlink(src)
                raise DigestMismatchError(f"expected {d}, got {actual}")
        dst = self.cache_path(d)
        with self._lock:
            if os.path.exists(dst):
                os.unlink(src)
                raise FileExistsInCacheError(str(d))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(src, dst)

    def partial_path(self, d: Digest) -> str:
        """Where an in-progress piece-wise download lives. Only a completed,
        verified blob ever occupies ``cache_path``, so ``in_cache`` means
        *committed*."""
        return self.cache_path(d) + ".part"

    def allocate_partial_file(self, d: Digest, length: int) -> str:
        """Pre-allocate the partial file for piece-wise download (resumable:
        the piece bitfield persists beside it). Returns the path."""
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
            if not os.path.exists(self.cache_path(d)):
                os.makedirs(os.path.dirname(self.cache_path(d)), exist_ok=True)
                os.replace(self.partial_path(d), self.cache_path(d))
            else:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(self.partial_path(d))

    # -- reads -------------------------------------------------------------

    def in_cache(self, d: Digest) -> bool:
        return os.path.exists(self.cache_path(d))

    def cache_size(self, d: Digest) -> int:
        try:
            return os.path.getsize(self.cache_path(d))
        except FileNotFoundError:
            raise KeyError(str(d)) from None

    def open_cache_file(self, d: Digest) -> BinaryIO:
        """Readable handle on a committed blob."""
        try:
            return open(self.cache_path(d), "rb")
        except FileNotFoundError:
            raise KeyError(str(d)) from None

    def read_cache_file(self, d: Digest) -> bytes:
        with self.open_cache_file(d) as f:
            return f.read()

    def list_cache_digests(self) -> list[Digest]:
        """Every committed blob, sorted by digest."""
        out = set()
        for _dirpath, _dirnames, filenames in os.walk(self.cache_dir):
            for name in filenames:
                if len(name) == 64 and "._md_" not in name:
                    out.add(name)
        return sorted(Digest.from_hex(h) for h in out)

    def delete_cache_file(self, d: Digest) -> None:
        """Remove a committed blob and every metadata sidecar beside it."""
        path = self.cache_path(d)
        with self._lock:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(path)
            for md in self._metadata_paths(path):
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(md)

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
        # Sidecars may precede their data file (a download's bitfield lives
        # beside the .part), so the shard dir may not exist yet.
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(md.serialize())
        os.replace(tmp, path)

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
