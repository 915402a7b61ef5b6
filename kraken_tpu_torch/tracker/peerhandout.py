"""Peer handout ordering: who an announcer should dial first.

The port's copy of ``kraken_tpu.tracker.peerhandout``.

Mirrors uber/kraken ``tracker/peerhandoutpolicy`` (``PriorityPolicy``
ordering the returned peer list, e.g. prefer non-origin complete peers) --
upstream path, unverified; SURVEY.md SS2.4.

Default policy: completeness-first among normal peers, origins last --
origins are the fallback seeders of last resort; spreading load onto agent
peers is the whole point of the P2P mesh.
"""

from __future__ import annotations

import random

from kraken_tpu_torch.core.peer import PeerInfo


def default_priority(peers: list[PeerInfo]) -> list[PeerInfo]:
    """Non-origin complete peers, then incomplete peers, then origins;
    random within a tier (load spreading)."""

    def tier(p: PeerInfo) -> int:
        if p.origin:
            return 2
        return 0 if p.complete else 1

    shuffled = list(peers)
    random.shuffle(shuffled)
    return sorted(shuffled, key=tier)


POLICIES = {"default": default_priority, "completeness": default_priority}


def get_policy(name: str):
    return POLICIES[name]
