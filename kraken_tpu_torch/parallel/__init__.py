"""Sharding of the GPU hash plane across devices and processes.

The port of ``kraken_tpu.parallel``. The piece batch is data-parallel on a
1-D ``pieces`` mesh of cards, and the small digest matrix (32 B a piece)
is gathered so every device holds the full result (``hashplane``); hosts
federate their hash planes over ``torch.distributed``, exchanging only
digests (``multihost``). Blob bytes move between hosts over TCP, as in
the reference. The reference's ``compat`` shim resolves JAX version skew
and has no counterpart here.
"""

from kraken_tpu_torch.parallel.mesh import PieceMesh, piece_mesh
from kraken_tpu_torch.parallel.hashplane import (
    ShardedPieceHasher,
    sharded_hash_pieces,
)

__all__ = ["PieceMesh", "piece_mesh", "sharded_hash_pieces", "ShardedPieceHasher"]
