"""Multi-host hash plane: hosts federate over ``torch.distributed``.

The port of ``kraken_tpu.parallel.multihost``. Every process hashes its
LOCAL piece batch on its local devices (piece bytes never cross hosts:
SHA-256 is data-parallel and blob bytes live where the store put them),
and the ``[N, 8]`` digest words are exchanged over a gloo process group:
32 B a piece of host-resident digests, the control-plane-sized traffic
the reference puts on its host transport. Gloo is used on the card too:
the digests are on the host when they are exchanged, and NCCL refuses two
ranks on one card.

The reference's ``hosts_mesh`` has no counterpart: the process group takes
its place.

Hermetic self-test: ``python -m kraken_tpu_torch.parallel.multihost
<proc> <nprocs> <port> [--platform cpu|cuda]`` (one process a rank; the
default platform is the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from kraken_tpu_torch.ops.sha256 import _digest_bytes
from kraken_tpu_torch.parallel.hashplane import sharded_hash_pieces
from kraken_tpu_torch.parallel.mesh import AXIS, PieceMesh, piece_mesh


def init_multihost(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join (or form) the multi-host group: a gloo process group whose
    rank 0 listens at ``coordinator_address`` (``host:port``). Call once a
    process; :func:`dist.destroy_process_group` leaves it."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """The federated topology, one per joined process."""

    process_id: int
    num_processes: int
    local_devices: tuple  # this host's own devices, in mesh order

    @classmethod
    def current(cls, platform: str | None = None) -> "MultihostContext":
        """This process's rank in the joined group, and its local devices:
        every card unless ``platform="cpu"`` (one CPU shard). Raises
        without a card unless asked for the CPU."""
        devices = piece_mesh(platform=platform).devices
        return cls(dist.get_rank(), dist.get_world_size(), devices)

    def local_mesh(self, axis: str = AXIS) -> PieceMesh:
        """This host's devices as the mesh :mod:`.hashplane` shards over."""
        return PieceMesh(self.local_devices, (axis,))


def _allgather_digests(ctx: MultihostContext, words_local: np.ndarray) -> list[np.ndarray]:
    """Exchange per-host ``[M_p, 8]`` uint32 digest words; returns one
    array per process, in process order, on every host.

    Two gathers, as in the reference: the counts first (a ``[1]`` int64 a
    process), then the words padded to the largest count (``[1, m_max,
    8]`` int32 bit patterns, on the host)."""
    count = torch.tensor([words_local.shape[0]], dtype=torch.int64)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(ctx.num_processes)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    m_max = max(counts)
    if m_max == 0:
        return [np.empty((0, 8), dtype=np.uint32) for _ in counts]
    padded = torch.zeros((1, m_max, 8), dtype=torch.int32)
    padded[0, : words_local.shape[0]] = torch.from_numpy(
        np.ascontiguousarray(words_local, dtype=np.uint32).view(np.int32)
    )
    gathered = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(gathered, padded)
    return [g[0, :c].numpy().view(np.uint32) for g, c in zip(gathered, counts)]


def multihost_hash_pieces(
    local_pieces: np.ndarray,
    piece_length: int,
    *,
    ctx: MultihostContext | None = None,
) -> np.ndarray:
    """Hash this host's ``[M_local, piece_length]`` uint8 batch on its
    local devices and return the GLOBAL ``[sum_p M_p, 32]`` uint8 digest
    matrix, in process order, on every host.

    The compute is :func:`~.hashplane.sharded_hash_pieces` over the local
    mesh; only the 32 B a piece of digests cross hosts. ``ctx=None`` takes
    :meth:`MultihostContext.current`, whose devices are the card's."""
    if ctx is None:
        ctx = MultihostContext.current()
    words = sharded_hash_pieces(ctx.local_mesh(), local_pieces, piece_length, replicate=False)
    parts = _allgather_digests(ctx, words.cpu().numpy().view(np.uint32))
    return _digest_bytes(torch.from_numpy(np.concatenate(parts).view(np.int32)))


def _batch_of(p: int, piece_length: int) -> np.ndarray:
    """Process ``p``'s self-test batch: ``3 + p`` rows (ragged counts
    exercise the count gather), the reference's seeds."""
    rng = np.random.default_rng(1000 + p)
    return rng.integers(0, 256, size=(3 + p, piece_length), dtype=np.uint8)


SELFTEST_PIECE = {"cpu": 256, "cuda": 4 << 20}


def _selftest(process_id: int, num_processes: int, port: int, platform: str = "cuda") -> None:
    """Joined by N processes: each hashes its own batch and checks the
    gathered global matrix against hashlib over EVERY process's batch
    (recomputed locally: no channel besides the collective under test).
    Prints ``MULTIHOST-OK proc=<p> digests=<n>``, the SHA-256 of the global
    matrix, this process's kernel launches and the walls of the hash and
    of a second gather alone."""
    import hashlib
    import json
    import time

    from kraken_tpu_torch.ops import sha256_cuda

    piece_length = SELFTEST_PIECE[platform]
    init_multihost(f"127.0.0.1:{port}", num_processes, process_id)
    try:
        ctx = MultihostContext.current(None if platform == "cuda" else platform)
        if ctx.num_processes != num_processes or ctx.process_id != process_id:
            raise AssertionError(f"joined as {ctx}")
        sha256_cuda.reset_launches()
        t0 = time.perf_counter()
        got = multihost_hash_pieces(_batch_of(process_id, piece_length), piece_length, ctx=ctx)
        wall_s = time.perf_counter() - t0
        launches = dict(sha256_cuda.LAUNCHES)
        want = b"".join(
            hashlib.sha256(row.tobytes()).digest()
            for p in range(num_processes) for row in _batch_of(p, piece_length)
        )
        if got.tobytes() != want:
            raise AssertionError("multihost digest mismatch")
        words = got.view(">u4").astype(np.uint32)
        offset = sum(3 + p for p in range(process_id))
        dist.barrier()
        t0 = time.perf_counter()
        again = _allgather_digests(ctx, words[offset : offset + 3 + process_id])
        gather_s = time.perf_counter() - t0
        if not np.array_equal(np.concatenate(again), words):
            raise AssertionError("the second gather differs from the first")
    finally:
        dist.destroy_process_group()
    stats = {"platform": platform, "piece_length": piece_length,
             "global_sha256": hashlib.sha256(got.tobytes()).hexdigest(),
             "launches": launches, "hash_and_gather_s": wall_s, "gather_s": gather_s}
    print(f"MULTIHOST-OK proc={process_id} digests={got.shape[0]} {json.dumps(stats)}",
          flush=True)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(prog="python -m kraken_tpu_torch.parallel.multihost")
    parser.add_argument("proc", type=int)
    parser.add_argument("nprocs", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("--platform", choices=sorted(SELFTEST_PIECE), default="cuda")
    a = parser.parse_args()
    _selftest(a.proc, a.nprocs, a.port, a.platform)
