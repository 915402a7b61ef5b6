"""Batched SHA-256 on the GPU: the ``cuda`` piece hasher.

The counterpart of ``kraken_tpu.ops.sha256.JaxPieceHasher``. SHA-256's
64-round chain cannot be parallelized within a message, so the gain comes
from the batch axis: every piece of a window is hashed by its own thread of
one kernel launch (:mod:`kraken_tpu_torch.ops.sha256_cuda`).

- ``hash_pieces`` (origin metainfo generation): the full pieces of a blob
  go through the uniform launch, ``sub_batch_bytes`` of them at a time; a
  short last piece goes through the ragged launch.
- ``hash_batch`` (agent verify): pieces of any length are copied into one
  staging buffer, each start 16-byte aligned, and hashed by the ragged
  launch, in groups whose staging buffer stays within ``sub_batch_bytes``.

Bytes reach the card through pinned host memory. The card returns digest
words; the host turns them into big-endian bytes with numpy.

Each group's stages are billed to the caller's hash plane
(``utils/trace.py``): ``stage`` (the pinned buffer and the copies into
it), ``submit`` (the host-to-device enqueue; the wrapper adds its launch),
``check`` (the ragged wrapper's bounds check) and ``readback``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kraken_tpu_torch.core.hasher import DIGEST_SIZE, PieceHasher, register_hasher
from kraken_tpu_torch.core.hasher import record_hash_metrics as _record_hash_metrics
from kraken_tpu_torch.ops import resolve_device
from kraken_tpu_torch.ops.sha256_cuda import sha256_ragged, sha256_uniform
from kraken_tpu_torch.utils import trace


def _digest_bytes(words: torch.Tensor) -> np.ndarray:
    """[N, 8] int32 digest words (uint32 bit patterns) -> [N, 32] uint8
    big-endian bytes."""
    w = words.cpu().numpy().view(np.uint32)
    return w.astype(">u4").view(np.uint8).reshape(-1, DIGEST_SIZE)


def _align16(n):
    return (n + 15) // 16 * 16


class TorchPieceHasher(PieceHasher):
    """Batched SHA-256 through the hand-written kernel (registered as
    ``cuda``).

    ``device=None`` means the card and raises ``RuntimeError`` when CUDA is
    absent; ``device="cpu"`` runs the plain PyTorch version of the kernel.
    ``sub_batch_bytes`` bounds the device working set per launch.
    """

    name = "cuda"

    def __init__(
        self,
        sub_batch_bytes: int = 256 * 1024 * 1024,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device, "TorchPieceHasher")
        self._sub_batch_bytes = sub_batch_bytes

    def _staging(self, nbytes: int) -> torch.Tensor:
        """A host buffer to fill; pinned when it is bound for the card."""
        return torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda"
        )

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True)

    # -- blob -> per-piece digests (origin metainfo-gen hot loop) ----------

    def hash_pieces(self, data: bytes | memoryview, piece_length: int) -> np.ndarray:
        if piece_length <= 0:
            raise ValueError(f"piece_length must be positive: {piece_length}")
        view = memoryview(data)
        total = len(view)
        if total == 0:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        start = time.perf_counter()
        n = (total + piece_length - 1) // piece_length
        n_full = total // piece_length
        src = np.frombuffer(view, dtype=np.uint8)
        per_batch = max(1, self._sub_batch_bytes // piece_length)
        outs = []
        for s in range(0, n_full, per_batch):
            g = min(per_batch, n_full - s)
            with trace.stage("stage"):
                host = self._staging(g * piece_length)
                host.numpy()[:] = src[s * piece_length : (s + g) * piece_length]
            with trace.stage("submit"):
                rows = self._to_device(host).view(g, piece_length)
            outs.append(sha256_uniform(rows))
        parts = []
        for o in outs:
            with trace.stage("readback"):
                parts.append(_digest_bytes(o))
        if n > n_full:
            parts.append(self._hash_batch_raw([view[n_full * piece_length :]]))
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        _record_hash_metrics("cuda", total, n, time.perf_counter() - start)
        return out

    # -- arbitrary piece batch (agent verify hot loop) ---------------------

    def hash_batch(self, pieces: list[bytes | memoryview]) -> np.ndarray:
        if not pieces:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        start = time.perf_counter()
        out = self._hash_batch_raw(pieces)
        # Recording lives here, not in _hash_batch_raw: hash_pieces routes
        # its short last piece through the raw variant and records the
        # blob's full total itself.
        _record_hash_metrics(
            "cuda", sum(len(memoryview(p)) for p in pieces), len(pieces),
            time.perf_counter() - start,
        )
        return out

    def _hash_batch_raw(self, pieces: list[bytes | memoryview]) -> np.ndarray:
        views = [memoryview(p) for p in pieces]
        n = len(views)
        lengths = np.array([len(v) for v in views], dtype=np.int64)
        sizes = _align16(lengths)
        out = np.empty((n, DIGEST_SIZE), dtype=np.uint8)
        s = 0
        while s < n:
            # Grow the group while its staging buffer stays within the
            # sub-batch budget; always take at least one piece.
            e, size = s + 1, int(sizes[s])
            while e < n and size + sizes[e] <= self._sub_batch_bytes:
                size += int(sizes[e])
                e += 1
            offsets = np.zeros(e - s, dtype=np.int64)
            np.cumsum(sizes[s : e - 1], out=offsets[1:])
            with trace.stage("stage"):
                host = self._staging(size)
                buf = host.numpy()
                for v, off in zip(views[s:e], offsets.tolist()):
                    buf[off : off + len(v)] = np.frombuffer(v, dtype=np.uint8)
            with trace.stage("submit"):
                flat = self._to_device(host)
                d_off = self._to_device(torch.from_numpy(offsets))
                d_len = self._to_device(torch.from_numpy(lengths[s:e]))
            words = sha256_ragged(flat, d_off, d_len)
            with trace.stage("readback"):
                out[s:e] = _digest_bytes(words)
            s = e
        return out


register_hasher("cuda", TorchPieceHasher)
