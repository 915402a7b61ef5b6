"""Blob placement: rendezvous hashing over health-filtered origin lists.

The port's copy of ``kraken_tpu.placement``.

Mirrors uber/kraken ``lib/hrw`` + ``lib/hashring`` + ``lib/hostlist`` +
``lib/healthcheck`` (SURVEY.md SS2.3): ``Ring.locations(digest)`` returns the
replica origins responsible for a blob, recomputed as membership/health
changes; every client of the origin cluster routes through it.
"""

from kraken_tpu_torch.placement.hrw import rendezvous_hash
from kraken_tpu_torch.placement.hashring import Ring
from kraken_tpu_torch.placement.hostlist import HostList
from kraken_tpu_torch.placement.healthcheck import PassiveFilter

__all__ = ["rendezvous_hash", "Ring", "HostList", "PassiveFilter"]
