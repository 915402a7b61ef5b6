"""Sharded piece hashing: the hash plane over a device mesh.

The port of ``kraken_tpu.parallel.hashplane``. The piece batch is split
row-wise across the ``pieces`` axis of a :class:`~.mesh.PieceMesh`; every
device runs the single-device SHA-256 kernel (``csrc/sha256.cu`` through
:func:`~kraken_tpu_torch.ops.sha256_cuda.sha256_uniform`) on its shard,
and the ``[M, 8]`` digest words are gathered (32 bytes a piece).

Where the reference's ``shard_map`` and ``jit`` place the shards and the
gather, the port does both explicitly: each shard is copied to its own
device through pinned host memory, every shard's launch is issued before
any digest is read back (so the cards of a mesh run together), and a
replicated result is one tensor per device. A mesh of CPU shards runs the
kernel's plain version on each.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kraken_tpu_torch.core.hasher import (
    DIGEST_SIZE,
    PieceHasher,
    record_hash_metrics,
    register_hasher,
)
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher, _digest_bytes
from kraken_tpu_torch.ops.sha256_cuda import sha256_uniform
from kraken_tpu_torch.parallel.mesh import PieceMesh, piece_mesh


def stage_sharded_pieces(
    mesh: PieceMesh, data_u8: np.ndarray, piece_length: int
) -> tuple[tuple[torch.Tensor, ...], int]:
    """TRANSFER stage of the sharded hash: pad ``[M, piece_length]`` uint8
    rows with zero rows to a multiple of ``mesh.size`` and place shard k,
    ``M_pad / size`` consecutive rows, on ``mesh.devices[k]`` (through
    pinned memory and a non-blocking copy on a card). Returns ``(staged,
    m)`` for :func:`hash_sharded_staged`. Split out so the ingest pipeline
    can bill the transfer and the hash of a window apart."""
    if piece_length <= 0 or piece_length % 64:
        raise ValueError("sharded path requires piece_length % 64 == 0")
    data_u8 = np.asarray(data_u8)
    if data_u8.dtype != np.uint8 or data_u8.ndim != 2 or data_u8.shape[1] != piece_length:
        raise ValueError(
            f"want [M, {piece_length}] uint8 rows, got {data_u8.dtype} {data_u8.shape}"
        )
    m = data_u8.shape[0]
    # Equal shards, as shard_map requires in the reference: the padding
    # rows sit at the end, so they are the tail of the last shards.
    per = -(-m // mesh.size)
    staged = []
    for k, device in enumerate(mesh.devices):
        rows = data_u8[min(k * per, m) : min((k + 1) * per, m)]
        on_card = device.type == "cuda"
        host = torch.empty((per, piece_length), dtype=torch.uint8, pin_memory=on_card)
        buf = host.numpy()
        buf[: len(rows)] = rows
        buf[len(rows) :] = 0
        # The caching host allocator keeps a pinned block until the copy
        # that reads it has run, so ``host`` may go out of scope here.
        staged.append(host.to(device, non_blocking=True) if on_card else host)
    return tuple(staged), m


def hash_sharded_staged(
    mesh: PieceMesh,
    staged: tuple[torch.Tensor, ...],
    m: int,
    piece_length: int,
    *,
    replicate: bool = True,
) -> torch.Tensor | tuple[torch.Tensor, ...]:
    """HASH stage over shards from :func:`stage_sharded_pieces`.

    Returns the ``[m, 8]`` int32 digest words (uint32 bit patterns) in row
    order, the padding rows sliced off. ``replicate=False`` gives one
    tensor on ``mesh.devices[0]``. ``replicate=True`` gives the
    counterpart of a fully replicated ``jax.Array``: a tuple with one full
    copy on each device of the mesh, in mesh order."""
    if len(staged) != mesh.size:
        raise ValueError(f"{len(staged)} shards for a mesh of {mesh.size}")
    # Every launch is queued before any result is read: on several cards
    # the shards hash together.
    words = [sha256_uniform(shard) for shard in staged]
    first = mesh.devices[0]
    full = torch.cat([w.to(first) for w in words])[:m]
    if not replicate:
        return full
    return (full,) + tuple(full.to(d, copy=True) for d in mesh.devices[1:])


def sharded_hash_pieces(
    mesh: PieceMesh,
    data_u8: np.ndarray,
    piece_length: int,
    *,
    replicate: bool = True,
) -> torch.Tensor | tuple[torch.Tensor, ...]:
    """Hash ``[M, piece_length]`` uint8 pieces data-parallel over ``mesh``.

    Returns the ``[M, 8]`` digest words as :func:`hash_sharded_staged`
    does. The reference's ``use_pallas`` and ``interpret`` have no
    counterpart: the mesh's devices decide, the kernel on a card and its
    plain PyTorch version on CPU shards. ``piece_length`` must be a
    multiple of 64 (ragged tails go through the single-device ragged
    kernel upstream of this call).
    """
    staged, m = stage_sharded_pieces(mesh, data_u8, piece_length)
    return hash_sharded_staged(mesh, staged, m, piece_length, replicate=replicate)


class ShardedPieceHasher(PieceHasher):
    """PieceHasher that fans the uniform fast path across every device of
    a mesh (``hasher: cuda-sharded`` in origin and agent YAML).

    ``mesh=None`` means every visible card and raises without one. A
    ragged tail piece, a ``piece_length`` that is not a multiple of 64 and
    ``hash_batch`` go through a single-device ``TorchPieceHasher`` on
    ``device``, the mesh's first device; they are a rounding error of the
    work. ``device`` is also where the ingest plane's packed windows run.
    """

    name = "cuda-sharded"

    def __init__(self, mesh: PieceMesh | None = None):
        self.mesh = mesh if mesh is not None else piece_mesh()
        self.device = self.mesh.devices[0]
        self._fallback = TorchPieceHasher(device=self.device)

    def hash_pieces(self, data, piece_length: int) -> np.ndarray:
        if piece_length <= 0:
            raise ValueError(f"piece_length must be positive: {piece_length}")
        view = memoryview(data)
        total = len(view)
        if total == 0:
            return np.empty((0, DIGEST_SIZE), dtype=np.uint8)
        if piece_length % 64:
            return self._fallback.hash_pieces(data, piece_length)
        start = time.perf_counter()
        n_full = total // piece_length
        n = -(-total // piece_length)
        out = []
        if n_full:
            arr = np.frombuffer(view[: n_full * piece_length], dtype=np.uint8)
            out.append(_digest_bytes(sharded_hash_pieces(
                self.mesh, arr.reshape(n_full, piece_length), piece_length,
                replicate=False,
            )))
        if n > n_full:
            # Raw: this call records the blob's full total below, and the
            # recording hash_batch would count the tail again.
            out.append(self._fallback._hash_batch_raw([view[n_full * piece_length :]]))
        record_hash_metrics(self.name, total, n, time.perf_counter() - start)
        return np.concatenate(out) if len(out) > 1 else out[0]

    def hash_batch(self, pieces) -> np.ndarray:
        return self._fallback.hash_batch(pieces)

    # -- staged-window protocol (core/ingest.py) --------------------------
    # stage_window and hash_staged_window split hash_pieces at the host ->
    # device boundary, so the ingest pipeline bills a window's transfer
    # and its hash apart. Digests equal hash_pieces': the same shards go
    # through the same kernel.

    def stage_window(self, arr: np.ndarray, piece_length: int):
        """Place one UNIFORM window (``[M, piece_length]`` uint8, every row
        a full piece) on the mesh. Returns an opaque handle. On a card the
        copies are queued, not waited for: their device time lands in
        :meth:`hash_staged_window`, whose readback waits for them."""
        staged, m = stage_sharded_pieces(self.mesh, arr, piece_length)
        return staged, m, piece_length

    def hash_staged_window(self, handle) -> np.ndarray:
        """Hash a :meth:`stage_window` handle -> ``[M, 32]`` uint8 digests."""
        staged, m, piece_length = handle
        start = time.perf_counter()
        out = _digest_bytes(
            hash_sharded_staged(self.mesh, staged, m, piece_length, replicate=False)
        )
        record_hash_metrics(self.name, m * piece_length, m, time.perf_counter() - start)
        return out


register_hasher("cuda-sharded", ShardedPieceHasher)
