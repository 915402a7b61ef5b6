"""Static or resolver-backed cluster host lists.

The port's copy of ``kraken_tpu.placement.hostlist``.

Mirrors uber/kraken ``lib/hostlist`` (static lists or DNS names resolved to
host sets) -- upstream path, unverified; SURVEY.md SS2.3. DNS is modeled as
a pluggable resolver callable so tests and the herd can inject membership
changes without real DNS.
"""

from __future__ import annotations

import socket
from typing import Callable, Iterable


class HostList:
    """A named set of ``host:port`` addresses."""

    def __init__(
        self,
        static: Iterable[str] | None = None,
        resolver: Callable[[], list[str]] | None = None,
    ):
        if (static is None) == (resolver is None):
            raise ValueError("exactly one of static/resolver required")
        self._static = sorted(static) if static is not None else None
        self._resolver = resolver

    def resolve(self) -> list[str]:
        if self._static is not None:
            return list(self._static)
        return sorted(self._resolver())

    @classmethod
    def from_dns(cls, name_port: str, scheme: str = "") -> "HostList":
        """Membership from a DNS name resolving to N A records
        (``name:port``; each resolved address joins as ``addr:port``, or
        ``scheme://addr:port`` when ``scheme`` is given -- TLS-fronted
        clusters resolve as https members). Resolution failures return the
        last good answer -- a DNS blip must not empty the ring and trigger
        a mass re-replication."""
        name, _, port = name_port.rpartition(":")
        if not name or not port.isdigit():
            raise ValueError(f"expected name:port, got {name_port!r}")
        prefix = f"{scheme}://" if scheme else ""
        last_good: list[str] = []

        def resolver() -> list[str]:
            nonlocal last_good
            try:
                # IPv4 only: members are formatted host:port throughout
                # (URLs, HRW keys, self_addr comparisons); bare IPv6 would
                # produce unparseable addresses downstream.
                infos = socket.getaddrinfo(
                    name, int(port), family=socket.AF_INET,
                    proto=socket.IPPROTO_TCP,
                )
            except OSError:
                return list(last_good)
            addrs = sorted({f"{prefix}{info[4][0]}:{port}" for info in infos})
            if addrs:
                last_good = addrs
            return addrs or list(last_good)

        return cls(resolver=resolver)
