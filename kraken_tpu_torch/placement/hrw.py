"""Rendezvous (highest-random-weight) hashing.

The port's copy of ``kraken_tpu.placement.hrw``.

Mirrors uber/kraken ``lib/hrw`` (``RendezvousHash`` used by the hashring)
-- upstream path, unverified; SURVEY.md SS2.3. Every (key, node) pair gets a
deterministic score; the top-k nodes own the key. Adding/removing a node
only moves the keys that scored highest on it -- minimal reshuffling,
no virtual-node ring maintenance.
"""

from __future__ import annotations

import hashlib
from typing import Sequence


def _score(key: str, node: str) -> int:
    return int.from_bytes(
        hashlib.sha256(f"{key}\x00{node}".encode()).digest()[:8], "big"
    )


def rendezvous_hash(key: str, nodes: Sequence[str], k: int = 1) -> list[str]:
    """Top-``k`` owners of ``key`` among ``nodes`` (score-descending,
    deterministic; ties broken by node name for stability)."""
    ranked = sorted(nodes, key=lambda n: (_score(key, n), n), reverse=True)
    return ranked[:k]
