"""The helper process of the agent cells: the tracker, the seeding peers
and the load generator, beside the process that hosts the agent.

The peers are the port's schedulers over origin-style archives of one
shared store that the bench wrote (they verify nothing); the tracker is
the port's ``TrackerNode``, its metainfo read from that store's
``torrentmeta`` sidecars, which the bench made on the card. The helper
touches no CUDA. It talks to the bench over a pipe, one message a step:

    bench -> helper      helper -> bench
    serve                ready (tracker address, the liar's peer id)
    agent                -
    warm (images)        warmed (records)
    window               done (image), ... window_done (records, lateness, load)
    free (image)         -
    liar                 liar_ready
    honest               honest_ready
    stop                 modules (the top-level names it loaded)

``load`` is the helper's CPU share and loop lag over the window
(``probe.LoadProbe``), so a run can show that the helper kept up.
"""

from __future__ import annotations

import asyncio
import os
import threading

from portbench import probe, traffic
from portbench.loadgen import LoadGen


class _Ring:
    resolved_hosts: list = []

    async def refresh_async(self) -> None:
        pass


class MetainfoBook:
    """Stands in for the origin cluster behind the tracker: the metainfo
    the bench made on the card, read from the store's sidecars."""

    ring = _Ring()

    def __init__(self, store):
        self.store = store

    async def get_metainfo(self, namespace, d):
        from kraken_tpu_torch.origin.metainfogen import TorrentMetaMetadata

        md = self.store.get_metadata(d, TorrentMetaMetadata)
        if md is None:
            raise KeyError(d.hex)
        return md.metainfo


def main(conn) -> None:
    asyncio.run(_main(conn))


def _pump(conn, loop, inbox) -> None:
    """Pipe -> the helper's loop. A bench that went away stops the helper."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            msg = ("stop",)
        loop.call_soon_threadsafe(inbox.put_nowait, msg)
        if msg[0] == "stop":
            return


async def _main(conn) -> None:
    loop = asyncio.get_running_loop()
    inbox: asyncio.Queue = asyncio.Queue()
    threading.Thread(target=_pump, args=(conn, loop, inbox), daemon=True).start()
    lock = threading.Lock()

    def send(*msg) -> None:
        with lock:
            conn.send(msg)

    from kraken_tpu_torch import BatchedVerifier, CAStore, Digest, OriginTorrentArchive, get_hasher
    from kraken_tpu_torch.assembly import TrackerNode
    from kraken_tpu_torch.core.peer import PeerID
    from kraken_tpu_torch.origin.metainfogen import TorrentMetaMetadata
    from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
    from kraken_tpu_torch.tracker.client import make_tracker_client

    msg = await inbox.get()
    if msg[0] != "serve":
        return
    s = msg[1]
    ns = s["namespace"]
    store = CAStore(s["store"])
    book = MetainfoBook(store)
    off = {"enabled": False}
    tracker = TrackerNode(host="127.0.0.1", port=0, origin_cluster=book,
                          announce_interval_seconds=s["announce_interval_s"],
                          peer_ttl_seconds=s["peer_ttl_s"], trace=off, profiling=off, slo=off)
    await tracker.start()
    verifier = BatchedVerifier(hasher=get_hasher("cpu"))  # seeders verify nothing
    config = SchedulerConfig(announce_interval_seconds=s["announce_interval_s"],
                             seed_announce_interval_seconds=s["seed_announce_s"])

    async def peer(peer_store) -> Scheduler:
        pid = PeerID(os.urandom(20).hex())
        client = make_tracker_client(tracker.addr, pid, "127.0.0.1", 0, is_origin=True)
        sched = Scheduler(pid, "127.0.0.1", 0, OriginTorrentArchive(peer_store, verifier),
                          client, client, config=config, is_origin=True)
        await sched.start()
        client.port = sched.port
        return sched

    def metainfos(k: int):
        return [store.get_metadata(Digest.from_hex(h), TorrentMetaMetadata).metainfo
                for h, _size in s["layers"][k]]

    seeders = [await peer(store) for _ in range(s["seeders"])]
    for k in s["seeded"]:
        for mi in metainfos(k):
            for sd in seeders:
                sd.seed(mi, ns)
    # The liar: a peer whose copy of one layer of its image has one byte
    # flipped in one piece, committed without a check.
    lie = s["liar"]
    liar_store = CAStore(s["liar_store"])
    for j, (h, size) in enumerate(s["layers"][lie["image"]]):
        data = bytearray(traffic.blob(s["seed"], (2, lie["image"], j), size))
        if j == lie["layer"]:
            data[lie["piece"] * lie["piece_length"] + 1234] ^= 0x01
        uid = liar_store.create_upload()
        liar_store.write_upload_chunk(uid, 0, bytes(data))
        liar_store.commit_upload(uid, Digest.from_hex(h), verify=False)
    liar = await peer(liar_store)
    send("ready", tracker.addr, liar.peer_id.hex)

    gen: LoadGen | None = None
    windows: set[asyncio.Task] = set()  # the loop holds tasks weakly
    try:
        while True:
            msg = await inbox.get()
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "agent":
                gen = LoadGen(msg[1], ns, s["layers"], lambda k: send("done", k))
            elif kind == "warm":
                send("warmed", await asyncio.to_thread(gen.pull_images, msg[1], s["grace_s"]))
            elif kind == "window":
                _t, t0, dues, pool, seconds, grace = msg
                load = probe.LoadProbe()
                load.start()
                task = asyncio.create_task(asyncio.to_thread(gen.window, t0, dues, pool,
                                                             seconds, grace))
                task.add_done_callback(
                    lambda t, load=load: send("window_done", *t.result(), load.stop()))
                windows.add(task)
                task.add_done_callback(windows.discard)
            elif kind == "free":
                gen.free(msg[1])
            elif kind == "liar":
                for mi in metainfos(lie["image"]):
                    liar.seed(mi, ns)
                send("liar_ready")
            elif kind == "honest":
                for mi in metainfos(lie["image"]):
                    for sd in seeders:
                        sd.seed(mi, ns)
                send("honest_ready")
    finally:
        for sched in seeders + [liar]:
            await sched.stop()
        await tracker.stop()
    try:
        send("modules", probe.top_modules())
    except OSError:  # the bench went away
        pass

