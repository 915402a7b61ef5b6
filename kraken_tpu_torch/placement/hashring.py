"""The origin hash ring: consistent blob -> replica-set placement.

The port's copy of ``kraken_tpu.placement.hashring``.

Mirrors uber/kraken ``lib/hashring`` (``Ring.Locations(digest) -> hosts``
with ``MaxReplica``, membership refreshed from hostlist filtered by health,
change notification driving repair) -- upstream path, unverified; SURVEY.md
SS2.3/SS5.
"""

from __future__ import annotations

from typing import Callable, Iterable

from kraken_tpu_torch.core.digest import Digest
from kraken_tpu_torch.placement.hostlist import HostList
from kraken_tpu_torch.placement.hrw import rendezvous_hash


class Ring:
    """Rendezvous ring over the healthy origins.

    ``health_filter`` is any callable(hosts) -> healthy subset (a
    PassiveFilter.filter, ActiveMonitor.filter, or None). ``refresh()``
    re-resolves membership and fires ``on_change`` listeners when it
    differs -- the origin repair path subscribes to re-replicate affected
    blobs.
    """

    def __init__(
        self,
        hosts: HostList,
        max_replica: int = 3,
        health_filter: Callable[[Iterable[str]], list[str]] | None = None,
    ):
        self._hosts = hosts
        self.max_replica = max_replica
        self._health_filter = health_filter
        self._members: list[str] = []
        self._resolved: list[str] = []
        self._listeners: list[Callable[[list[str]], None]] = []
        self.refresh()

    @property
    def members(self) -> list[str]:
        return list(self._members)

    def all_hosts(self) -> list[str]:
        """Unfiltered membership -- what health monitors must keep probing
        (a host filtered out of ``members`` still needs probes to recover)."""
        return self._hosts.resolve()

    @property
    def resolved_hosts(self) -> list[str]:
        """The unfiltered host list from the most recent refresh -- lets
        periodic loops probe and refresh with ONE resolve per tick (DNS
        resolution is not free)."""
        return list(self._resolved)

    def on_change(self, fn: Callable[[list[str]], None]) -> None:
        self._listeners.append(fn)

    def set_health_filter(
        self, fn: Callable[[Iterable[str]], list[str]] | None
    ) -> None:
        """Attach/replace the health filter (nodes that own a monitor wire
        it here after construction)."""
        self._health_filter = fn

    @property
    def has_health_filter(self) -> bool:
        return self._health_filter is not None

    def refresh(self) -> bool:
        """Re-resolve + re-filter membership; returns True if it changed."""
        return self._apply(self._hosts.resolve())

    async def refresh_async(self) -> bool:
        """`refresh` with the resolve off-loop: a DNS-backed HostList can
        block for a resolver timeout, which must not freeze the event loop
        (the node would fail its own health probes). Filtering and change
        notification still run on the loop, so ``on_change`` listeners may
        schedule tasks."""
        import asyncio

        return self._apply(await asyncio.to_thread(self._hosts.resolve))

    def _apply(self, hosts: list[str]) -> bool:
        self._resolved = list(hosts)
        if self._health_filter is not None:
            hosts = self._health_filter(hosts)
        hosts = sorted(hosts)
        if hosts == self._members:
            return False
        self._members = hosts
        for fn in self._listeners:
            fn(list(hosts))
        return True

    def locations(self, d: Digest) -> list[str]:
        """The replica origins responsible for ``d`` (= min(max_replica,
        cluster size) hosts, deterministic for fixed membership)."""
        if not self._members:
            raise RuntimeError("hash ring has no members")
        return rendezvous_hash(d.hex, self._members, k=self.max_replica)

    def owns(self, host: str, d: Digest) -> bool:
        return host in self.locations(d)
