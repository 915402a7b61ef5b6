"""Cold image pulls through one port agent, an open loop at a fixed rate.

This process hosts the agent, built by ``assembly.AgentNode`` from the
configuration's YAML, as a node's agent process would; the helper process
(``portbench.helper``) hosts the tracker, the seeding peers and the load
generator. Each image is the configuration's layers, seeded bytes given
their metainfo on the card by the port's ``Generator`` in set-up. An image
that was pulled is evicted the way the agent's own cleanup evicts
(``CleanupManager`` and its ``after_evict``, which drops the torrent too)
and only then is due again, so every pull is cold.

After the window, one more image is served first by a peer that lies about
one piece: the agent has to ban it for a digest mismatch on the card and
finish the pull from honest peers.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import statistics
import threading
import time

from portbench import helper, port, probe, readers, traffic
from portbench.harness import Context, Outcome
from portbench.loadgen import get_layer
from portbench.reference import metainfo as ref

LIAR_PIECE = 5


def build_agent(yaml: dict, store_root: str, tracker_addr: str):
    """An ``AgentNode`` from a node's YAML, as ``kraken-tpu agent`` builds
    one; the addresses and the store are this run's own."""
    from kraken_tpu_torch.assembly import AgentNode
    from kraken_tpu_torch.p2p.scheduler import SchedulerConfig
    from kraken_tpu_torch.store.cleanup import CleanupConfig
    from kraken_tpu_torch.utils.deadline import RPCConfig

    sched = yaml.get("scheduler")
    return AgentNode(
        store_root=store_root, tracker_addr=tracker_addr, host="127.0.0.1",
        http_port=0, p2p_port=0, hasher=yaml["hasher"],
        hash_workers=int(yaml.get("hash_workers", 1)),
        cleanup=CleanupConfig(**yaml["cleanup"]),
        scheduler_config=SchedulerConfig.from_dict(sched) if sched else None,
        p2p_bandwidth=yaml.get("p2p_bandwidth"),
        tag_cache_ttl=float(yaml.get("tag_cache_ttl", 0.0)),
        durability=yaml.get("durability", "rename"),
        registry_strict_accept=bool(yaml.get("registry_strict_accept", False)),
        scrub=yaml.get("scrub"), fsck=bool(yaml.get("fsck", True)),
        rpc=RPCConfig.from_dict(yaml.get("rpc")), resources=yaml.get("resources"),
        trace=yaml.get("trace"), delta=yaml.get("delta"), profiling=yaml.get("profiling"),
        chunkstore=yaml.get("chunkstore"), slo=yaml.get("slo"), canary=yaml.get("canary"),
        ingest=yaml.get("ingest"), pex=yaml.get("pex"),
    )


def _plant(node, fault: str | None, control: bool) -> None:
    """The control: a verify that takes every piece unhashed (the
    configuration's guarantee that each piece is verified, broken). The
    faults (CPU rehearsals): a piece altered as it is written; a write that
    leaves the file as it was; a verify flush that hashes half its rows."""
    from kraken_tpu_torch.p2p.storage import Torrent

    if control:
        async def accept(data, expected):
            return True
        node.verifier.verify = accept
    if fault == "alter_answer":
        real = Torrent._write_at

        def write_at(self, i, data):
            data = bytearray(data)
            data[0] ^= 0x01
            real(self, i, bytes(data))
        Torrent._write_at = write_at
    elif fault == "unchanged_state":
        Torrent._write_at = lambda self, i, data: None
    elif fault == "half_batch":
        import numpy as np

        hasher = node.verifier.hasher
        real_batch = hasher.hash_batch

        def hash_batch(pieces):
            keep = len(pieces) // 2
            out = np.zeros((len(pieces), 32), dtype=np.uint8)
            if keep:
                out[:keep] = real_batch(pieces[:keep])
            return out
        hasher.hash_batch = hash_batch


class Session:
    """One agent, one helper, one image pool: set up once, then any number
    of windows (the sweep runs several), the liar's check, and close."""

    def __init__(self, ctx: Context, pool: int, grace: float, warm: int = 1):
        cfg = ctx.config
        self.ctx, self.seed, self.grace = ctx, ctx.args.seed, grace
        self.namespace = cfg["namespace"]
        self.sizes = [size for _n, size in (cfg["rehearsal"]["layers"] if ctx.cpu
                                            else cfg["layers"])]
        self.pool = list(range(pool))
        # The warm-up pulls the first ``warm`` images of the pool at once (the
        # concurrency the window's bursts reach), then evicts them.
        self.warm = self.pool[:warm]
        self.liar = pool
        self.images = pool + 1
        self.mis: dict[tuple[int, int], object] = {}
        self.digests: list[list[str]] = []
        self.node = None
        self.helper_modules: list[str] | None = None  # reported by the helper as it stops
        self._evictions: set[asyncio.Task] = set()

    # -- the pipe to the helper ---------------------------------------------

    def _pump(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                self.loop.call_soon_threadsafe(self.replies.put_nowait, ("gone",))
                return
            if msg[0] == "done":
                self.loop.call_soon_threadsafe(self._on_done, msg[1])
            else:
                self.loop.call_soon_threadsafe(self.replies.put_nowait, msg)

    def send(self, *msg) -> None:
        self.conn.send(msg)

    async def reply_any(self, timeout: float):
        return await asyncio.wait_for(self.replies.get(), timeout)

    async def reply(self, kind: str, timeout: float = 300.0):
        msg = await self.reply_any(timeout)
        if msg[0] != kind:
            raise RuntimeError(f"helper: expected {kind}, got {msg[0]}")
        return msg

    def _on_done(self, k: int) -> None:
        t = asyncio.ensure_future(self._evict_and_free(k))
        self._evictions.add(t)
        t.add_done_callback(self._evictions.discard)

    async def _evict_and_free(self, k: int) -> None:
        await self.evict(k)
        self.send("free", k)

    async def evict(self, k: int) -> None:
        from kraken_tpu_torch import Digest

        for h in self.digests[k]:
            d = Digest.from_hex(h)
            if self.node.store.in_cache(d):
                await asyncio.to_thread(self.node.cleanup._evict, d)

    # -- set-up ---------------------------------------------------------------

    async def setup(self) -> None:
        ctx = self.ctx
        marks = self.setup_marks = {}
        mark = lambda name: marks.__setitem__(name, time.monotonic() - ctx.t_start)
        mark("imports")
        self.loop = asyncio.get_running_loop()
        self.replies: asyncio.Queue = asyncio.Queue()
        mp = multiprocessing.get_context("spawn")
        self.conn, child = mp.Pipe()
        self.proc = mp.Process(target=helper.main, args=(child,), name="portbench-helper")
        self.proc.start()  # its imports overlap the data and the metainfo below
        child.close()
        threading.Thread(target=self._pump, daemon=True).start()
        if ctx.cpu:
            port.ask_for_cpu()
        from kraken_tpu_torch import CAStore, Digest, Generator

        store_root = str(ctx.workdir / "seed")
        store = CAStore(store_root)
        for k in range(self.images):
            row = []
            for j, size in enumerate(self.sizes):
                data = traffic.blob(self.seed, (2, k, j), size)
                d = Digest.from_bytes(data)
                uid = store.create_upload()
                store.write_upload_chunk(uid, 0, data)
                store.commit_upload(uid, d, verify=False)
                row.append(d.hex)
            self.digests.append(row)
        mark("data")
        gen = Generator(store)  # the card's metainfo, as the origin would make it
        for k in range(self.images):
            for j, h in enumerate(self.digests[k]):
                self.mis[(k, j)] = gen.generate_sync(Digest.from_hex(h))
        mark("metainfo")
        layers = [[(h, size) for h, size in zip(row, self.sizes)] for row in self.digests]
        tr = ctx.traffic
        self.send("serve", {
            "namespace": self.namespace, "store": store_root,
            "liar_store": str(ctx.workdir / "liar"), "seed": self.seed,
            "layers": layers, "seeded": self.pool,
            "seeders": ctx.config["seeders"],
            "announce_interval_s": tr["announce_interval_s"], "peer_ttl_s": tr["peer_ttl_s"],
            "seed_announce_s": tr["seed_announce_s"], "grace_s": self.grace,
            "liar": {"image": self.liar, "layer": len(self.sizes) - 1, "piece": LIAR_PIECE
                     if not ctx.cpu else 0, "piece_length": self.mis[(self.liar, 0)].piece_length},
        })
        _k, tracker_addr, self.liar_hex = await self.reply("ready")
        mark("helper_ready")
        yaml = port.node_yaml(ctx.config)
        self.node = build_agent(yaml, str(ctx.workdir / "agent"), tracker_addr)
        await self.node.start()
        mark("agent_started")
        self.send("agent", self.node.addr)
        self.send("warm", self.warm)
        _k, warmed = await self.reply("warmed")
        if any(r["status"] != 200 for r in warmed):
            raise RuntimeError(f"warm-up pull failed: {warmed}")
        for k in self.warm:
            await self.evict(k)
        mark("warm_pull")
        _plant(self.node, ctx.args.fault, ctx.args.control)

    # -- a window ---------------------------------------------------------------

    async def window(self, rate: float, seconds: float, trace=None) -> dict:
        dues = traffic.arrivals(self.seed, rate, seconds, self.ctx.traffic["arrivals_key"])
        before = port.counters()
        self.ctx.window_opens()
        if trace:
            trace.open()
        t0 = time.monotonic()
        self.send("window", t0, dues, self.pool, seconds, self.grace)
        load = probe.LoadProbe()
        load.start()
        await asyncio.sleep(max(0.0, t0 + seconds - time.monotonic()))
        if trace:
            trace.close()
        at_close = port.counters()
        _k, records, late, helper_load = await self.reply("window_done",
                                                          seconds + self.grace + 120)
        agent_load = load.stop()
        while self._evictions:
            await asyncio.gather(*list(self._evictions))
        settled = port.rise(before, port.counters())
        settled["bytes_needed"] = sum(r["size"] for r in records if r["status"] == 200)
        return {"rate": rate, "window_s": seconds, "grace_s": self.grace, "pulls": records,
                "late": late, "load": {"agent": agent_load, "helper": helper_load},
                "counters": {"window": port.rise(before, at_close), "settled": settled}}

    async def reset(self) -> None:
        """Evict every image of the pool still cached (between windows)."""
        for k in self.pool:
            await self.evict(k)

    # -- after the window -------------------------------------------------------

    async def liar_check(self) -> dict:
        """The liar serves its image first; once the agent has banned it,
        honest peers seed the image too and the pull completes."""
        from kraken_tpu_torch.core.peer import PeerID
        from kraken_tpu_torch.p2p.networkevent import Producer

        sched = self.node.scheduler
        events = Producer("agent")
        sched.events = events
        self.send("liar")
        await self.reply("liar_ready")
        pulls = [asyncio.ensure_future(asyncio.to_thread(
            get_layer, self.node.addr, self.namespace, h, 2 * self.grace))
            for h in self.digests[self.liar]]
        liar = PeerID(self.liar_hex)
        lied = self.mis[(self.liar, len(self.sizes) - 1)].info_hash
        deadline = time.monotonic() + self.grace
        banned = False
        while time.monotonic() < deadline and not all(p.done() for p in pulls):
            if sched.conn_state.blacklist.blocked(liar, lied):
                banned = True
                break
            await asyncio.sleep(0.01)
        if banned:
            self.send("honest")
            await self.reply("honest_ready")
        got = await asyncio.gather(*pulls)
        bans = [e for e in events.events if e["name"] == "blacklist_conn"
                and e.get("peer") == self.liar_hex and "digest mismatch" in e.get("reason", "")]
        return {"pulls": got, "banned_for_mismatch": bool(bans)}

    async def close(self) -> None:
        if self.proc.is_alive():
            try:
                self.send("stop")
                while self.helper_modules is None:
                    msg = await self.reply_any(30)
                    if msg[0] == "modules":
                        self.helper_modules = msg[1]
                    elif msg[0] == "gone":
                        break
            except (OSError, asyncio.TimeoutError):
                pass
            await asyncio.to_thread(self.proc.join, 30)
        if self.proc.is_alive():
            self.proc.terminate()
            await asyncio.to_thread(self.proc.join, 10)
        if self.node is not None:
            await self.node.stop()
            self.node = None

    # -- the reference ----------------------------------------------------------

    def judge(self, records: list[dict], liar: dict) -> dict[str, tuple[float, float]]:
        """Every body served, every metainfo made in set-up and the liar's
        image, against what the reference works out from the seeded bytes."""
        table = self.ctx.config["piece_lengths"]
        want = {(k, j): ref.expected(traffic.blob(self.seed, (2, k, j), size), table)
                for k in range(self.images) for j, size in enumerate(self.sizes)}
        mi_wrong = sum(ref.metainfo_wrong(
            {"digest": mi.digest.hex, "length": mi.length, "piece_length": mi.piece_length,
             "piece_hashes": mi.piece_hashes}, want[kj]) for kj, mi in self.mis.items())

        def wrong(k, j, r) -> bool:
            return r["digest"] != want[(k, j)]["digest"] or r["bytes"] != want[(k, j)]["length"]

        served = [r for r in records if r["status"] == 200]
        liar_wrong = any(r["status"] != 200 or wrong(self.liar, j, r)
                         for j, r in enumerate(liar["pulls"]))
        return {
            "pulls_not_served": (len(records) - len(served), 0),
            "bodies_wrong": (sum(wrong(r["image"], r["layer"], r) for r in served), 0),
            "metainfo_wrong": (mi_wrong, 0),
            "liar_not_banned": (int(not liar["banned_for_mismatch"]), 0),
            "liar_pull_wrong": (int(liar_wrong), 0),
        }


def image_spans(records: list[dict]) -> list[tuple[float, float]]:
    """(due, last byte) of each image offered; an image not served ends never."""
    spans: dict = {}
    for r in records:
        end = r["end"] if r["status"] == 200 and r["end"] is not None else float("inf")
        a, b = spans.get((r["image"], r["due"]), (r["due"], end))
        spans[(r["image"], r["due"])] = (a, max(b, end))
    return list(spans.values())


def in_flight_max(records: list[dict]) -> int:
    spans = image_spans(records)
    edges = sorted([(a, 1) for a, _b in spans] + [(b, -1) for _a, b in spans])
    peak = cur = 0
    for _t, step in edges:
        cur += step
        peak = max(peak, cur)
    return peak


def lateness(w: dict, pool: int) -> dict:
    """How late the generator ran, and the pulls' spread, for the record."""
    lat = readers.pull_latencies(w)
    return {"loadgen": {"images_due": len(w["late"]), "late_p50_s": statistics.median(w["late"]),
                        "late_max_s": max(w["late"]), "pool_images": pool,
                        "images_in_flight_max": in_flight_max(w["pulls"]),
                        "pulls": len(lat), **{f"pull_p{q}_s": readers.rank(lat, q / 100)
                                              for q in (50, 80, 90, 100)},
                        "dup_bytes_ratio": readers.ratio(w, "settled", "bytes_down", "bytes_needed"),
                        "verify_rows_per_launch": readers.ratio(w, "window", "verify_pieces",
                                                                "launches.sha256_ragged"),
                        "load": w["load"]}}


async def _run(ctx: Context) -> Outcome:
    tr = tr_all = ctx.traffic
    if ctx.cpu:
        tr = {**tr_all, **tr_all["rehearsal"]}
    s = Session(ctx, tr["pool_images"], tr["grace_s"], tr["warm_images"])
    try:
        await s.setup()
        trace = None
        if ctx.args.trace and not ctx.cpu:  # a CPU run reads no device metric
            from portbench.devtrace import DeviceTrace

            trace = DeviceTrace(ctx.workdir)
            trace.start()
        w = await s.window(tr["images_per_s"], ctx.args.seconds, trace)
        peak = port.memory_peak_bytes(ctx.cpu)
        summary = trace.summary() if trace else None
        liar = await s.liar_check()
    finally:
        await s.close()
    if s.helper_modules is None:
        raise RuntimeError("the helper stopped without naming the modules it loaded")
    checks = s.judge(w["pulls"], liar)
    obs = {**w, "trace": summary}
    return Outcome(obs=obs, attempted=len(w["pulls"]),
                   failed=sum(r["status"] != 200 for r in w["pulls"]), checks=checks,
                   memory_peak_bytes=peak, trace=summary, child_modules=s.helper_modules,
                   lines=[{"setup_s_at": s.setup_marks}, lateness(w, len(s.pool)),
                          {"pulls_due_and_s": [[round(p["due"], 3), round(lat, 3)] for p, lat
                                               in zip(w["pulls"], readers.pull_latencies(w))]}])


def run(ctx: Context) -> Outcome:
    return asyncio.run(_run(ctx))
