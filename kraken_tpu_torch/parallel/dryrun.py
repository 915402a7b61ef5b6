"""Hermetic multi-device dry run of the sharded hash plane.

The port of ``kraken_tpu.parallel.dryrun``: ``python -m
kraken_tpu_torch.parallel.dryrun N`` hashes ``4N + 1`` rows (ragged
against the device quantum) on a mesh of N CPU shards, gathers the digest
words to every shard, checks every copy against hashlib and prints
``dryrun ok``.

Hermeticity contract, the counterpart of the reference's transfer guard:
the run never initialises CUDA, whatever the environment holds (a bogus
``CUDA_VISIBLE_DEVICES``, a card that is there or not). The mesh is
asked for ``platform="cpu"`` and the end of the run checks
``torch.cuda.is_initialized()``.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from kraken_tpu_torch.ops.sha256 import _digest_bytes
from kraken_tpu_torch.parallel import piece_mesh, sharded_hash_pieces


def run_dryrun(n_devices: int) -> None:
    """One sharded step on ``n_devices`` CPU shards, replicated and checked
    against hashlib; raises ``AssertionError`` on any mismatch."""
    mesh = piece_mesh(n_devices, platform="cpu")
    piece_len = 256  # 4 SHA blocks a piece
    n = 4 * n_devices + 1
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(n, piece_len), dtype=np.uint8)
    want = b"".join(hashlib.sha256(row.tobytes()).digest() for row in data)

    copies = sharded_hash_pieces(mesh, data, piece_len, replicate=True)
    if len(copies) != n_devices:
        raise AssertionError(f"digest gather missing: {len(copies)} copies on {n_devices}")
    for k, (words, device) in enumerate(zip(copies, mesh.devices)):
        if words.shape != (n, 8) or words.device != device:
            raise AssertionError(f"copy {k}: {tuple(words.shape)} on {words.device}")
        if _digest_bytes(words).tobytes() != want:
            raise AssertionError(f"multi-device digest mismatch vs hashlib (copy {k})")
    if torch.cuda.is_initialized():
        raise AssertionError("the dry run initialised CUDA")


if __name__ == "__main__":
    run_dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun ok")
