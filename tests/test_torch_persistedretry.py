"""The port's ``persistedretry`` held against ``kraken_tpu.persistedretry``:
the same sqlite schema and rows, so a retry DB written by one package is
run by the other; plus the reference's own cases (dedup, prefix counts,
key canonicalization, backoff, task timeout, a poll that rides out store
errors) on the port."""

import asyncio
import sqlite3
import time

import pytest

import kraken_tpu.persistedretry as jax_retry
import kraken_tpu_torch.persistedretry as port_retry
from kraken_tpu_torch.persistedretry import Manager, Task, TaskStore
from kraken_tpu_torch.utils.backoff import Backoff
from kraken_tpu_torch.utils.metrics import REGISTRY

PKG = {"jax": jax_retry, "port": port_retry}
PAIRS = [("jax", "port"), ("port", "jax")]


def _tasks(pkg):
    T = PKG[pkg].Task
    return [
        T(kind="replicate", key=f"{'ab' * 32}:ns:127.0.0.1:{7000 + i}",
          payload={"addr": f"127.0.0.1:{7000 + i}", "namespace": "ns", "digest": "ab" * 32})
        for i in range(3)
    ] + [T(kind="writeback", key=f"{'cd' * 32}:ns", payload={"namespace": "ns",
                                                               "digest": "cd" * 32})]


def test_the_schema_is_the_references(tmp_path):
    PKG["jax"].TaskStore(str(tmp_path / "j.db")).close()
    PKG["port"].TaskStore(str(tmp_path / "p.db")).close()

    def schema(path):
        with sqlite3.connect(path) as db:
            return db.execute("SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()

    assert schema(tmp_path / "p.db") == schema(tmp_path / "j.db")


@pytest.mark.parametrize("writer,runner", PAIRS)
def test_a_retry_db_written_by_one_package_is_run_by_the_other(tmp_path, writer, runner):
    db = str(tmp_path / "retry.db")
    w = PKG[writer].TaskStore(db)
    assert w.add_many(_tasks(writer)) == 4
    assert not w.add(_tasks(writer)[0])  # (kind, key) dedup
    w.close()

    async def main():
        store = PKG[runner].TaskStore(db)
        m = PKG[runner].Manager(store)
        seen = []

        async def ok(task):
            seen.append((task.kind, task.key, task.payload))

        async def fail(task):
            raise RuntimeError("backend down")

        m.register("replicate", ok)
        m.register("writeback", fail)
        assert store.count_pending("replicate", f"{'ab' * 32}:") == 3
        done = await m.run_once()
        pending = store.all_pending()
        m.close()
        return done, seen, pending

    done, seen, pending = asyncio.run(main())
    assert done == 3
    assert seen == [(t.kind, t.key, t.payload) for t in _tasks(runner)[:3]]
    (wb,) = pending
    assert (wb.kind, wb.attempts) == ("writeback", 1) and wb.not_before > time.time()
    # The writer's package reads back what the runner left.
    back = PKG[writer].TaskStore(db)
    (row,) = back.all_pending()
    assert (row.kind, row.key, row.payload, row.attempts) == (
        wb.kind, wb.key, wb.payload, wb.attempts)
    back.close()


def test_prefix_counts_and_kinds():
    s = TaskStore(":memory:")
    for t in _tasks("port"):
        assert s.add(t)
    assert s.count_pending("replicate", "ab") == 3
    assert s.count_pending("replicate", "cd") == 0
    assert s.count_pending("writeback") == 1
    assert s.count_by_kind() == {"replicate": 3, "writeback": 1}
    # A "*" in a prefix is literal, never a glob.
    s.add(Task(kind="k", key="a*b", payload={}))
    s.add(Task(kind="k", key="axb", payload={}))
    assert s.count_pending("k", "a*") == 1


@pytest.mark.parametrize("legacy_first", [True, False])
def test_canonicalize_rewrites_legacy_keys_and_drops_duplicates(legacy_first):
    s = TaskStore(":memory:")
    payload = {"addr": "h:1", "namespace": "ns", "digest": "ab" * 32}
    legacy = Task(kind="replicate", key=f"h:1:ns:{'ab' * 32}", payload=payload)
    canonical = Task(kind="replicate", key=f"{'ab' * 32}:ns:h:1", payload=payload)
    for t in ([legacy, canonical] if legacy_first else [legacy]):
        s.add(t)
    changed = s.canonicalize_keys("replicate", lambda p: f"{p['digest']}:{p['namespace']}:{p['addr']}")
    assert changed == 1
    assert [t.key for t in s.all_pending()] == [canonical.key]


def test_failures_back_off_and_max_attempts_drop():
    async def main():
        m = Manager(TaskStore(":memory:"), backoff=Backoff(base_seconds=10.0, jitter=0),
                    max_attempts=2)

        async def fail(task):
            raise RuntimeError("no")

        m.register("k", fail)
        m.add(Task(kind="k", key="x", payload={}))
        now = time.time()
        assert await m.run_once(now) == 0
        (t,) = m.store.all_pending()
        assert t.attempts == 1 and t.not_before == pytest.approx(now + 10.0)
        assert await m.run_once(now) == 0  # not due yet
        assert await m.run_once(now + 11) == 0  # second failure: dropped
        assert m.store.all_pending() == []
        assert m.queue_depths() == {"k": 0}

    asyncio.run(main())


def test_retry_task_timeout_reschedules_and_counts():
    async def main():
        m = Manager(TaskStore(":memory:"),
                    backoff=Backoff(base_seconds=100.0, max_seconds=1000.0, jitter=0),
                    task_timeout_seconds=0.05)
        started = asyncio.Event()

        async def hang(task):
            started.set()
            await asyncio.sleep(60)

        done = []

        async def quick(task):
            done.append(task.key)

        m.register("hang", hang)
        m.register("quick", quick)
        m.add(Task(kind="hang", key="h", payload={}))
        m.add(Task(kind="quick", key="q", payload={}))
        t0 = REGISTRY.counter("retry_task_timeouts_total").value(kind="hang")
        ok = await m.run_once()
        assert started.is_set()
        assert ok == 1 and done == ["q"]
        assert REGISTRY.counter("retry_task_timeouts_total").value(kind="hang") == t0 + 1
        (pending,) = m.store.all_pending()
        assert pending.kind == "hang" and pending.attempts == 1
        assert pending.not_before > time.time() + 50

    asyncio.run(main())


def test_retry_poll_survives_store_errors():
    class FlakyStore(TaskStore):
        def __init__(self):
            super().__init__(":memory:")
            self.failures_left = 2

        def ready(self, now, limit=100):
            if self.failures_left > 0:
                self.failures_left -= 1
                raise sqlite3.OperationalError("disk I/O error")
            return super().ready(now, limit)

    async def main():
        m = Manager(FlakyStore(), poll_interval_seconds=0.01)
        done = []

        async def ok(task):
            done.append(task.key)

        m.register("k", ok)
        m.add(Task(kind="k", key="x", payload={}))
        base = REGISTRY.counter("retry_poll_errors_total").value()
        m.start()
        try:
            deadline = asyncio.get_running_loop().time() + 10
            while not done:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
        finally:
            m.stop()
            await m.reap()
        assert done == ["x"]
        assert REGISTRY.counter("retry_poll_errors_total").value() == base + 2

    asyncio.run(main())
