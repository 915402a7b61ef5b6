"""Delta-transfer config: the YAML ``delta:`` section.

The port's part of ``kraken_tpu.p2p.delta``: only the config and its
``from_dict``, so the shipped files load. The planner and the origin's
``/recipe`` route wait for the chunk tier (ROADMAP A7f):
``enabled: true`` raises ``ValueError`` naming the key and A7f, at start
and on SIGHUP alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeltaConfig:
    """The YAML ``delta:`` section, every field of the reference's.
    Shipped OFF."""

    enabled: bool = False
    min_blob_bytes: int = 4 << 20
    max_bases: int = 3
    min_jaccard: float = 0.1
    min_piece_cover: float = 0.25
    range_fetch: bool = True

    def __post_init__(self) -> None:
        if self.enabled:
            raise ValueError(
                "delta.enabled: delta pulls and the /recipe route are not"
                " ported yet (ROADMAP A7f)"
            )

    @classmethod
    def from_dict(cls, doc: dict | None) -> "DeltaConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown delta config keys: {sorted(unknown)}")
        return cls(**doc)
