"""sqlite-backed durable retry queue: the port's copy of
``kraken_tpu.persistedretry.manager``. The table and its rows are the
reference's, byte for byte, so either package runs the other's queue."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import sqlite3
import time
from typing import Awaitable, Callable, Optional

from kraken_tpu_torch.utils.backoff import Backoff

_log = logging.getLogger("kraken.persistedretry")


@dataclasses.dataclass
class Task:
    """One durable unit of work. ``kind`` routes to an executor; ``payload``
    is executor-defined JSON. ``key`` dedups (same-key add is a no-op while
    the task is pending)."""

    kind: str
    key: str
    payload: dict
    attempts: int = 0
    not_before: float = 0.0
    id: Optional[int] = None


class TaskStore:
    """Persistence layer. One table, tiny schema, crash-safe."""

    def __init__(self, path: str):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._db = sqlite3.connect(path)
        # WAL + synchronous=NORMAL: commits survive process crash always
        # and power loss up to the last WAL checkpoint sync -- the right
        # durability/cost point for a retry queue (a lost row re-enqueues
        # on the next trigger; a corrupt rollback journal would not).
        # ":memory:" (tests) doesn't support WAL; it reports its mode.
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            """CREATE TABLE IF NOT EXISTS tasks (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                kind TEXT NOT NULL,
                key TEXT NOT NULL,
                payload TEXT NOT NULL,
                attempts INTEGER NOT NULL DEFAULT 0,
                not_before REAL NOT NULL DEFAULT 0,
                UNIQUE(kind, key)
            )"""
        )
        self._db.commit()

    def add(self, task: Task) -> bool:
        """Insert; returns False if a pending task with the same (kind, key)
        already exists."""
        try:
            cur = self._db.execute(
                "INSERT INTO tasks (kind, key, payload, attempts, not_before)"
                " VALUES (?, ?, ?, ?, ?)",
                (task.kind, task.key, json.dumps(task.payload), task.attempts,
                 task.not_before),
            )
            self._db.commit()
            task.id = cur.lastrowid
            return True
        except sqlite3.IntegrityError:
            return False

    def add_many(self, tasks: list[Task]) -> int:
        """Bulk insert in ONE transaction (one fsync, not len(tasks));
        existing (kind, key) rows are skipped. Returns rows inserted.
        Bulk enqueuers (the repair path) would otherwise stall the caller
        on a commit per task."""
        before = self._db.total_changes
        self._db.executemany(
            "INSERT OR IGNORE INTO tasks"
            " (kind, key, payload, attempts, not_before)"
            " VALUES (?, ?, ?, ?, ?)",
            [
                (t.kind, t.key, json.dumps(t.payload), t.attempts, t.not_before)
                for t in tasks
            ],
        )
        self._db.commit()
        return self._db.total_changes - before

    def ready(self, now: float, limit: int = 100) -> list[Task]:
        rows = self._db.execute(
            "SELECT id, kind, key, payload, attempts, not_before FROM tasks"
            " WHERE not_before <= ? ORDER BY id LIMIT ?",
            (now, limit),
        ).fetchall()
        return [
            Task(kind=k, key=key, payload=json.loads(p), attempts=a,
                 not_before=nb, id=i)
            for i, k, key, p, a, nb in rows
        ]

    def all_pending(self) -> list[Task]:
        return self.ready(now=float("inf"), limit=1_000_000)

    def count_pending(self, kind: str, key_prefix: str = "") -> int:
        """Pending tasks of ``kind`` whose key starts with ``key_prefix``
        (the replication unpin logic asks "any other task for this blob?")."""
        row = self._db.execute(
            "SELECT COUNT(*) FROM tasks WHERE kind = ? AND key GLOB ?",
            (kind, key_prefix.replace("*", "[*]") + "*"),
        ).fetchone()
        return int(row[0])

    def count_by_kind(self) -> dict[str, int]:
        """Pending tasks per kind, one aggregate scan -- the sentinel's
        queue-depth sample (a wedged executor shows up here as one kind
        growing without bound while the others drain)."""
        rows = self._db.execute(
            "SELECT kind, COUNT(*) FROM tasks GROUP BY kind"
        ).fetchall()
        return {kind: int(n) for kind, n in rows}

    def canonicalize_keys(self, kind: str, canonical: Callable[[dict], str]) -> int:
        """Rewrite pending keys of ``kind`` to ``canonical(payload)``.

        Key formats have changed across builds (digest-first reordering);
        tasks persisted by an older build still execute correctly from
        their payload but are invisible to the ``count_pending`` prefix
        scans the unpin logic relies on -- which can release an eviction
        pin while a legacy-keyed task for the same blob is still queued.
        Executors call this once at registration with their canonical key
        derivation. A legacy row whose canonical key already exists is a
        duplicate of the pending canonical task and is dropped. Returns
        rows migrated (rewritten + dropped)."""
        rows = self._db.execute(
            "SELECT id, key, payload FROM tasks WHERE kind = ?", (kind,)
        ).fetchall()
        changed = 0
        for row_id, key, payload in rows:
            want = canonical(json.loads(payload))
            if key == want:
                continue
            try:
                self._db.execute(
                    "UPDATE tasks SET key = ? WHERE id = ?", (want, row_id)
                )
            except sqlite3.IntegrityError:
                self._db.execute("DELETE FROM tasks WHERE id = ?", (row_id,))
            changed += 1
        if changed:
            self._db.commit()
        return changed

    def done(self, task: Task) -> None:
        self._db.execute("DELETE FROM tasks WHERE id = ?", (task.id,))
        self._db.commit()

    def reschedule(self, task: Task, not_before: float) -> None:
        self._db.execute(
            "UPDATE tasks SET attempts = ?, not_before = ? WHERE id = ?",
            (task.attempts, not_before, task.id),
        )
        self._db.commit()

    def close(self) -> None:
        self._db.close()


class Manager:
    """Polls the store and runs tasks through registered executors.

    ``register(kind, fn)`` with ``fn(task) -> Awaitable[None]``; a raise
    reschedules with exponential backoff. Call ``run_once()`` from tests or
    ``start()`` for the background loop.
    """

    def __init__(
        self,
        store: TaskStore,
        poll_interval_seconds: float = 1.0,
        backoff: Backoff | None = None,
        max_attempts: int = 0,  # 0 = retry forever (reference semantics)
        task_timeout_seconds: float = 1800.0,  # 0 = no per-task timeout
    ):
        self.store = store
        self.poll_interval = poll_interval_seconds
        self.backoff = backoff or Backoff(base_seconds=1.0, max_seconds=300.0)
        self.max_attempts = max_attempts
        # One poll loop serves EVERY task kind, so a single hung executor
        # (a writeback upload wedged on a dead backend socket) would
        # stall writeback, replication, AND heal forever. The timeout is
        # generous -- a multi-GiB writeback legitimately takes minutes --
        # but it must exist: a timed-out task just reschedules with
        # backoff like any other failure.
        self.task_timeout = task_timeout_seconds
        self._executors: dict[str, Callable[[Task], Awaitable[None]]] = {}
        self._task: Optional[asyncio.Task] = None
        self._poll_failures = None  # lazy FailureMeter (start() only)

    def register(self, kind: str, fn: Callable[[Task], Awaitable[None]]) -> None:
        self._executors[kind] = fn

    def add(self, task: Task) -> bool:
        return self.store.add(task)

    def add_many(self, tasks: list[Task]) -> int:
        return self.store.add_many(tasks)

    def queue_depths(self) -> dict[str, int]:
        """Pending depth per kind, REGISTERED kinds always present (a
        healthy empty queue reports 0, not absence -- the sentinel's
        gauge must not drop a label the moment a queue drains)."""
        depths = {kind: 0 for kind in self._executors}
        depths.update(self.store.count_by_kind())
        return depths

    async def run_once(self, now: float | None = None) -> int:
        """One poll cycle; returns number of tasks that succeeded."""
        now = time.time() if now is None else now
        ok = 0
        for task in self.store.ready(now):
            fn = self._executors.get(task.kind)
            if fn is None:
                continue  # executor not registered (yet); leave queued
            try:
                if self.task_timeout > 0:
                    try:
                        await asyncio.wait_for(fn(task), self.task_timeout)
                    except asyncio.TimeoutError:
                        from kraken_tpu_torch.utils.metrics import REGISTRY

                        REGISTRY.counter(
                            "retry_task_timeouts_total",
                            "Retry tasks cancelled at task_timeout_seconds",
                        ).inc(kind=task.kind)
                        _log.warning(
                            "retry task timed out; rescheduling",
                            extra={
                                "kind": task.kind, "key": task.key,
                                "timeout_seconds": self.task_timeout,
                            },
                        )
                        raise
                else:
                    await fn(task)
            except Exception:
                task.attempts += 1
                if self.max_attempts and task.attempts >= self.max_attempts:
                    self.store.done(task)
                else:
                    self.store.reschedule(
                        task, now + self.backoff.delay(task.attempts - 1)
                    )
            else:
                self.store.done(task)
                ok += 1
        return ok

    def start(self) -> None:
        # The poll itself can raise (transient sqlite disk error in
        # store.ready, or done/reschedule mid-cycle). An unguarded loop
        # dies SILENTLY on the first such error -- every durable plane
        # (writeback, replication, heal) then stops forever while the
        # process looks healthy. Meter + structured WARN + keep polling.
        from kraken_tpu_torch.utils.metrics import FailureMeter

        if self._poll_failures is None:
            self._poll_failures = FailureMeter(
                "retry_poll_errors_total",
                "Retry-queue poll cycles that raised (loop kept polling)",
                _log,
            )

        async def loop():
            while True:
                try:
                    await self.run_once()
                except Exception as e:
                    self._poll_failures.record("retry poll", e)
                await asyncio.sleep(self.poll_interval)

        self._task = asyncio.create_task(loop())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    async def reap(self) -> None:
        """Await the cancelled poll task (after :meth:`stop`, before
        :meth:`close`). cancel() only SCHEDULES the CancelledError --
        it lands at the task's next await -- so closing the sqlite
        store while run_once is still in flight turns shutdown into
        "Cannot operate on a closed database" poll noise and strands
        the task past the test body (the asyncio-task tripwire and the
        `fire-and-forget-task` lint rule exist for exactly this class).
        Idempotent; cancels too if stop() was skipped."""
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        except Exception:
            _log.debug("retry poll task raised at shutdown", exc_info=True)
        self._task = None

    def close(self) -> None:
        """Release the task store's sqlite handle. Call AFTER stop()
        and after the node's listeners are down: a request handler
        mid-commit may still enqueue until then, and the poll task's
        cancellation lands at its next await -- neither touches the DB
        afterwards (it lives on the loop thread). Without this, every
        node start/stop cycle strands one sqlite fd -- the exact slow
        EMFILE class the resource sentinel + soak harness exist to
        catch (and did)."""
        self.store.close()
