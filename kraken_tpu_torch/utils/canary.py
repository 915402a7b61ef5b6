"""Synthetic canary config: the YAML ``canary:`` section.

The port's part of ``kraken_tpu.utils.canary``: only the config and its
``from_dict``, so the shipped files load. The prober waits for the
debug slice (ROADMAP A7e): ``enabled: true`` raises ``ValueError``
naming the key and A7e, at start and on SIGHUP alike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """The YAML ``canary:`` section, every field of the reference's.
    Shipped OFF."""

    enabled: bool = False
    interval_seconds: float = 60.0
    blob_bytes: int = 262144
    origins: str = ""
    pull_timeout_seconds: float = 30.0
    ttl_seconds: float = 600.0
    upload_chunk_bytes: int = 65536

    @classmethod
    def from_dict(cls, doc: dict | None) -> "CanaryConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown canary config keys: {sorted(unknown)}")
        cfg = cls(**doc)
        if cfg.interval_seconds <= 0 or cfg.pull_timeout_seconds <= 0:
            raise ValueError(
                "canary interval_seconds and pull_timeout_seconds"
                " must be > 0"
            )
        if cfg.blob_bytes <= 0:
            raise ValueError("canary blob_bytes must be > 0")
        return cfg

    def __post_init__(self) -> None:
        if self.enabled:
            raise ValueError(
                "canary.enabled: the canary prober is not ported yet"
                " (ROADMAP A7e)"
            )
