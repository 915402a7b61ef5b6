"""Durable async task queue with retry/backoff, surviving restarts.

Mirrors uber/kraken ``lib/persistedretry`` (tasks persisted locally;
executors retry with backoff until success; writeback and tag-replication
ride on it so crashes never lose work) -- upstream path, unverified;
SURVEY.md SS2.3/SS5. Persistence is stdlib sqlite3; the port's copy of
``kraken_tpu.persistedretry``.
"""

from kraken_tpu_torch.persistedretry.manager import Manager, Task, TaskStore

__all__ = ["Manager", "Task", "TaskStore"]
