"""Resource sentinel config: the YAML ``resources:`` section.

The port's part of ``kraken_tpu.utils.resources``: only the config and
its ``from_dict``, so the shipped files load. The sentinel itself (the
fd / RSS / task / bufpool / conn / orphan audit, its ``resource_*``
gauges and ``/debug/resources``) waits for the debug slice (ROADMAP
A7e) and is not started, even observe-only. A budget above 0 or
``drain_on_breach: true`` asks the sentinel to act, so such a value
raises ``ValueError`` naming the key and A7e, at start and on SIGHUP
alike; the shipped values (every budget 0, no drain) load.
"""

from __future__ import annotations

import dataclasses

# The fields that turn the sentinel's budgets on (0 / False = off).
_BUDGET_KEYS = (
    "max_open_fds", "max_rss_mb", "max_tasks", "max_bufpool_leased",
    "max_conns", "max_orphans", "loop_lag_p99_seconds", "max_retry_queue",
    "drain_on_breach",
)


@dataclasses.dataclass
class ResourcesConfig:
    """The YAML ``resources:`` section, every field of the reference's.
    Budgets of 0 are OFF."""

    interval_seconds: float = 30.0
    max_open_fds: int = 0
    max_rss_mb: float = 0.0
    max_tasks: int = 0
    max_bufpool_leased: int = 0
    max_conns: int = 0
    max_orphans: int = 0
    loop_lag_p99_seconds: float = 0.0
    max_retry_queue: int = 0
    breach_streak: int = 3
    drain_on_breach: bool = False
    top_tasks: int = 8
    orphan_min_age_seconds: float = 60.0

    def __post_init__(self) -> None:
        asked = [k for k in _BUDGET_KEYS if getattr(self, k)]
        if asked:
            raise ValueError(
                f"resources {asked}: the resource sentinel is not ported"
                " yet (ROADMAP A7e); leave every budget at 0 and"
                " drain_on_breach false"
            )

    @classmethod
    def from_dict(cls, doc: dict | None) -> "ResourcesConfig":
        doc = dict(doc or {})
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(
                f"unknown resources config keys: {sorted(unknown)}"
            )
        return cls(**doc)
