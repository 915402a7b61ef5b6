"""Component entry points: one long-running process per component.

The port's copy of the ``tracker``, ``origin``, ``agent``, ``build-index``
and ``proxy`` subcommands of ``kraken_tpu.cli``:

    python -m kraken_tpu_torch.cli tracker     --config config/tracker/development.yaml
    python -m kraken_tpu_torch.cli origin      --config config/origin/development.yaml --hasher cuda
    python -m kraken_tpu_torch.cli agent       --config config/agent/development.yaml --hasher cuda \
                                               --registry-port 0 --build-index host:7620
    python -m kraken_tpu_torch.cli build-index --config config/build-index/base.yaml --store ./bi \
                                               --origins host:7610
    python -m kraken_tpu_torch.cli proxy       --config config/proxy/base.yaml \
                                               --origins host:7610 --build-index host:7620

Config YAML keys mirror the constructor arguments of the assembly nodes
(:mod:`kraken_tpu_torch.assembly`); flags override config values. The
YAML is read by the port's own reader (``utils/yaml_lite.py``). Each node
prints one ``READY {json}`` line once it listens (an agent with a registry
endpoint adds its ``registry_addr``). SIGTERM drains and then stops,
SIGINT stops, SIGHUP re-reads ``--config`` and applies what reloads live
(a reload that raises keeps the current config).

``--hasher`` takes ``cpu`` and ``cuda`` (a ``cuda`` node without a card
exits non-zero before its READY line); the shipped files' ``hasher: tpu``
is refused unless a flag overrides it. The build-index and the proxy hash
nothing on a card, in the reference either. A top-level key that no node
of the component reads is logged, never dropped silently. The other
subcommands of the reference exit 2 with a message naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

from kraken_tpu_torch.configutil import load_config

# The reference's other subcommands, and the ROADMAP item that ports each.
NOT_PORTED = {
    "status": "A7e",
    "trace": "A7e",
    "flame": "A7e",
    "scrub": "A7h",
    "fsck": "A7h",
    "lint": "A7h",
    "promgen": "A7h",
    "locate": "A7h",
    "testfs": "A7h",
}

# Top-level keys each component reads (beside the flags). Keys in
# IGNORED are read by no node of that component in the reference either
# (the tracker, the build-index and the proxy hold no CAStore: the shared
# base's cleanup: is not theirs).
_LISTENER_KEYS = {"host", "port", "failpoints", "tls", "tls_client", "rpc"}
_COMMON_KEYS = _LISTENER_KEYS | {"trace", "profiling", "slo"}
READS = {
    "build-index": _LISTENER_KEYS | {
        "store", "origins", "remotes", "backends", "immutable_tags",
        "task_timeout_seconds", "max_replica",
    },
    "proxy": _LISTENER_KEYS | {"origins", "build_index", "spool", "max_replica"},
    "tracker": _COMMON_KEYS | {
        "origins", "announce_interval_seconds", "peer_ttl_seconds",
        "peerstore_redis", "fleet", "self_addr", "max_replica",
    },
    "origin": _COMMON_KEYS | {
        "store", "tracker", "p2p_port", "hasher", "hash_workers",
        "scheduler", "cluster", "cluster_dns", "self_addr", "max_replica",
        "durability", "fsck", "scrub", "task_timeout_seconds", "backends",
        "resources", "delta", "chunkstore", "ingest", "quorum", "cleanup",
        "dedup_index", "dedup_budget_bytes", "dedup_low_j_bands",
        "p2p_bandwidth",
    },
    "agent": _COMMON_KEYS | {
        "store", "tracker", "p2p_port", "hasher", "hash_workers",
        "registry_strict_accept", "scheduler", "fsck", "scrub", "resources",
        "delta", "chunkstore", "canary", "pex", "ingest", "cleanup",
        "durability", "p2p_bandwidth", "registry_port", "build_index",
        "tag_cache_ttl",
    },
}
IGNORED = {"tracker": {"cleanup"}, "origin": set(), "agent": set(),
           "build-index": {"cleanup"}, "proxy": {"cleanup"}}


async def _run_until_signal(node, describe: dict,
                            config_path: str | None = None) -> None:
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    # SIGTERM (orchestrated shutdown) gets the lameduck drain, then the
    # clean stop. SIGINT (an operator's ^C) stops immediately.
    drain_requested = False

    def on_sigterm() -> None:
        nonlocal drain_requested
        drain_requested = True
        stop.set()

    def reload_config() -> None:
        # SIGHUP = re-read --config and apply what reloads live.
        log = logging.getLogger("kraken.cli")
        if config_path is None or not hasattr(node, "reload"):
            log.info("SIGHUP ignored (no --config or nothing reloadable)")
            return
        try:
            node.reload(load_config(config_path))
            log.info("config reloaded", extra={"path": config_path})
        except Exception:
            log.exception("config reload failed; keeping current config")

    # Handlers BEFORE the READY line: herd managers signal as soon as they
    # see it, and an unhandled SIGHUP's default action kills the process.
    loop.add_signal_handler(signal.SIGINT, stop.set)
    loop.add_signal_handler(signal.SIGTERM, on_sigterm)
    loop.add_signal_handler(signal.SIGHUP, reload_config)

    await node.start()
    describe["addr"] = node.addr
    # Agents with the docker-registry read endpoint enabled bind it on its
    # own (possibly ephemeral) port; report it so harnesses can find it.
    if getattr(node, "registry_addr", None):
        describe["registry_addr"] = node.registry_addr
    # One machine-readable line so herd harnesses can scrape the bound ports.
    print("READY " + json.dumps(describe), flush=True)
    await stop.wait()
    if drain_requested and hasattr(node, "drain"):
        await node.drain()
    await node.stop()


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None, help="HTTP port")


def _warn_unread(component: str, cfg: dict) -> None:
    unread = sorted(set(cfg) - READS[component] - IGNORED[component])
    if unread:
        logging.getLogger("kraken.cli").warning(
            "config keys that no %s node reads: %s", component, unread
        )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="kraken-tpu-torch")
    sub = parser.add_subparsers(dest="component", required=True)

    p_tracker = sub.add_parser("tracker")
    _common(p_tracker)
    p_tracker.add_argument("--origins", default=None,
                           help="comma-separated origin http addrs")
    p_tracker.add_argument("--fleet", default=None,
                           help="comma-separated addrs of the WHOLE"
                                " tracker fleet (including this one)")
    p_tracker.add_argument("--self-addr", default=None,
                           help="this tracker's address AS IT APPEARS in"
                                " --fleet (required with --fleet)")

    p_origin = sub.add_parser("origin")
    _common(p_origin)
    p_origin.add_argument("--store", default=None)
    p_origin.add_argument("--tracker", default=None,
                          help="tracker addr, or a comma-separated fleet")
    p_origin.add_argument("--p2p-port", type=int, default=None)
    p_origin.add_argument("--hasher", default=None, choices=["cpu", "cuda"])
    p_origin.add_argument("--hash-workers", type=int, default=None,
                          help="host piece-hash pool size (cpu hasher);"
                               " 0 = strictly serial")
    p_origin.add_argument("--cluster", default=None,
                          help="comma-separated origin http addrs (incl. self)")
    p_origin.add_argument("--cluster-dns", default=None,
                          help="host:port whose DNS A/AAAA records are the"
                               " ring membership; exclusive with --cluster")
    p_origin.add_argument("--self-addr", default=None,
                          help="this origin's address AS IT APPEARS in"
                               " --cluster (required with --cluster)")
    p_origin.add_argument("--scrub-bps", type=float, default=None,
                          help="background integrity-scrub read budget in"
                               " bytes/sec (overrides scrub.bytes_per_second;"
                               " 0 = unthrottled)")
    p_origin.add_argument("--data-plane-workers", type=int, default=None,
                          help="seed-serve worker processes (overrides"
                               " scheduler.data_plane_workers); only 0 is"
                               " taken until ROADMAP A7g")

    p_agent = sub.add_parser("agent")
    _common(p_agent)
    p_agent.add_argument("--store", default=None)
    p_agent.add_argument("--tracker", default=None,
                         help="tracker addr, or a comma-separated fleet")
    p_agent.add_argument("--p2p-port", type=int, default=None)
    p_agent.add_argument("--hasher", default=None, choices=["cpu", "cuda"])
    p_agent.add_argument("--hash-workers", type=int, default=None,
                         help="host piece-hash pool size for the verify"
                              " plane (cpu hasher); 0 = strictly serial")
    p_agent.add_argument("--registry-port", type=int, default=None,
                         help="serve the docker-registry read API here"
                              " (requires --build-index)")
    p_agent.add_argument("--build-index", default=None,
                         help="build-index addr for tag -> digest lookups")
    p_agent.add_argument("--scrub-bps", type=float, default=None,
                         help="background integrity-scrub read budget in"
                              " bytes/sec (overrides scrub.bytes_per_second;"
                              " 0 = unthrottled)")
    p_agent.add_argument("--data-plane-workers", type=int, default=None,
                         help="seed-serve worker processes (overrides"
                              " scheduler.data_plane_workers); only 0 is"
                              " taken until ROADMAP A7g")
    p_agent.add_argument("--leech-workers", type=int, default=None,
                         help="download-pump worker processes (overrides"
                              " scheduler.leech_workers); only 0 is taken"
                              " until ROADMAP A7g")

    p_bi = sub.add_parser("build-index")
    _common(p_bi)
    p_bi.add_argument("--store", default=None)
    p_bi.add_argument("--origins", default=None,
                      help="comma-separated origin http addrs (tag"
                           " dependency resolution)")
    p_bi.add_argument("--remotes", default=None,
                      help="comma-separated remote build-index addrs"
                           " (cross-cluster tag replication)")

    p_proxy = sub.add_parser("proxy")
    _common(p_proxy)
    p_proxy.add_argument("--origins", default=None,
                         help="comma-separated origin http addrs")
    p_proxy.add_argument("--build-index", default=None,
                         help="build-index addr for tag puts")
    p_proxy.add_argument("--spool", default=None,
                         help="durable spool root: upload sessions survive"
                              " proxy restarts (docker push resumes)")

    for name, item in NOT_PORTED.items():
        p = sub.add_parser(name, help=f"not ported yet (ROADMAP {item})")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        # Before parsing: the subcommand's own flags are not the port's.
        parser.exit(2, f"kraken-tpu-torch: the {argv[0]!r} subcommand is not"
                       f" ported yet (ROADMAP {NOT_PORTED[argv[0]]}); run it"
                       " with python -m kraken_tpu.cli\n")
    args = parser.parse_args(argv)

    # The heavy imports (torch, the nodes) wait until a node is asked for.
    from kraken_tpu_torch.assembly import (
        AgentNode,
        BuildIndexNode,
        OriginNode,
        ProxyNode,
        TrackerNode,
    )
    from kraken_tpu_torch.backend import Manager as BackendManager
    from kraken_tpu_torch.origin.client import ClusterClient
    from kraken_tpu_torch.p2p.scheduler import SchedulerConfig
    from kraken_tpu_torch.placement import HostList, Ring
    from kraken_tpu_torch.placement.healthcheck import PassiveFilter
    from kraken_tpu_torch.store.cleanup import CleanupConfig
    from kraken_tpu_torch.tracker.client import parse_tracker_addrs
    from kraken_tpu_torch.utils import failpoints as _failpoints
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.structlog import setup_json_logging

    cfg = load_config(args.config) if args.config else {}
    setup_json_logging(args.component)
    _warn_unread(args.component, cfg)

    # Chaos plane (utils/failpoints.py). Env KRAKEN_FAILPOINTS is self-
    # acknowledging; a YAML `failpoints:` mapping additionally requires
    # KRAKEN_FAILPOINTS_ALLOW=1 so a chaos config pasted into production
    # fails the boot loudly -- assembly re-checks before binding.
    _failpoints.load_from_env()
    fp_cfg = cfg.get("failpoints")
    if fp_cfg:
        if os.environ.get("KRAKEN_FAILPOINTS_ALLOW") != "1":
            parser.error(
                "config arms failpoints ({}) but KRAKEN_FAILPOINTS_ALLOW=1"
                " is not set; refusing to boot an injecting node by"
                " accident".format(sorted(fp_cfg))
            )
        for fp_name, fp_spec in fp_cfg.items():
            _failpoints.FAILPOINTS.arm(
                str(fp_name), str(fp_spec), source="yaml"
            )
        _failpoints.allow()

    def pick(flag, key, default=None):
        return flag if flag is not None else cfg.get(key, default)

    # YAML: cleanup: {tti_seconds, watermarks, interval_seconds,
    # upload_ttl_seconds} -- absent = eviction off.
    cleanup_cfg = cfg.get("cleanup")
    cleanup = CleanupConfig(**cleanup_cfg) if cleanup_cfg else None

    # YAML: scrub: -- absent = background scrubbing off. --scrub-bps
    # overrides the budget (and enables scrubbing with defaults when no
    # section exists). fsck: false disables the startup reconciliation.
    scrub_cfg = cfg.get("scrub")
    if getattr(args, "scrub_bps", None) is not None:
        scrub_cfg = dict(scrub_cfg or {})
        scrub_cfg["bytes_per_second"] = args.scrub_bps
    fsck_enabled = bool(cfg.get("fsck", True))

    scheduler_cfg = cfg.get("scheduler")
    if getattr(args, "data_plane_workers", None) is not None:
        scheduler_cfg = dict(scheduler_cfg or {})
        scheduler_cfg["data_plane_workers"] = args.data_plane_workers
    if getattr(args, "leech_workers", None) is not None:
        scheduler_cfg = dict(scheduler_cfg or {})
        scheduler_cfg["leech_workers"] = args.leech_workers

    # YAML: tls: {cert, key[, client_ca]} -- terminate TLS on the HTTP
    # listener; with client_ca, REQUIRE client certificates (mTLS).
    tls_cfg = cfg.get("tls")
    ssl_context = None
    if tls_cfg:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(tls_cfg["cert"], tls_cfg["key"])
        if tls_cfg.get("client_ca"):
            ssl_context.load_verify_locations(cafile=tls_cfg["client_ca"])
            ssl_context.verify_mode = ssl.CERT_REQUIRED

    # YAML: tls_client: {cert, key[, ca]} -- this process's OUTBOUND
    # identity: system roots PLUS the cluster CA.
    tlsc_cfg = cfg.get("tls_client")
    if tlsc_cfg:
        import ssl

        from kraken_tpu_torch.utils.httputil import set_default_client_ssl

        client_ctx = ssl.create_default_context()
        if tlsc_cfg.get("ca"):
            client_ctx.load_verify_locations(cafile=tlsc_cfg["ca"])
        client_ctx.load_cert_chain(tlsc_cfg["cert"], tlsc_cfg["key"])
        set_default_client_ssl(client_ctx)

    host = pick(args.host, "host", "127.0.0.1")
    port = pick(args.port, "port", 0)
    rpc_cfg = RPCConfig.from_dict(cfg.get("rpc"))

    def origin_cluster(origins: str | None, component: str) -> ClusterClient | None:
        """Ring-resolved origin cluster client behind a circuit breaker."""
        addrs = [a for a in (origins or "").split(",") if a]
        if not addrs:
            return None
        health = PassiveFilter(
            brownout_threshold_seconds=rpc_cfg.brownout_threshold_seconds,
            name=f"{component}-origin-breaker",
        )
        return ClusterClient(
            Ring(HostList(static=addrs),
                 max_replica=cfg.get("max_replica", 3),
                 health_filter=health.filter),
            health=health,
            hedge_delay_seconds=rpc_cfg.hedge_delay_seconds,
            deadline_seconds=rpc_cfg.request_deadline_seconds,
            component=component,
        )

    def hasher_of() -> str:
        # The flag wins; the shipped base files' `hasher: tpu` is refused
        # by the node (ValueError naming the port's hashers).
        return pick(args.hasher, "hasher", "cuda")

    if args.component == "tracker":
        cluster = origin_cluster(pick(args.origins, "origins", ""), "tracker")
        fleet = pick(args.fleet, "fleet", "") or ""
        tracker_self = (pick(args.self_addr, "self_addr", "") or "").strip()
        fleet_addrs = parse_tracker_addrs(fleet)
        if fleet_addrs and not tracker_self:
            parser.error("--fleet requires --self-addr (this tracker's"
                         " addr as it appears in the fleet list)")
        if fleet_addrs and tracker_self not in fleet_addrs:
            parser.error(
                f"--self-addr {tracker_self!r} does not appear in --fleet"
                " (must match one entry verbatim)"
            )
        try:
            node = TrackerNode(
                host=host, port=port, origin_cluster=cluster,
                announce_interval_seconds=cfg.get("announce_interval_seconds", 3.0),
                peer_ttl_seconds=cfg.get("peer_ttl_seconds", 30.0),
                redis_addr=cfg.get("peerstore_redis", ""),
                fleet=fleet_addrs,
                self_addr=tracker_self,
                ssl_context=ssl_context,
                rpc=rpc_cfg,
                trace=cfg.get("trace"),
                profiling=cfg.get("profiling"),
                slo=cfg.get("slo"),
            )
        except ValueError as e:
            # A refused value (a hasher, a plane that waits): no READY.
            parser.error(str(e))
        asyncio.run(
            _run_until_signal(node, {"component": "tracker"}, args.config)
        )

    elif args.component == "origin":
        backends_cfg = cfg.get("backends")
        backends = BackendManager(backends_cfg) if backends_cfg else None
        cluster_addrs = [
            a for a in (pick(args.cluster, "cluster", "") or "").split(",") if a
        ]
        cluster_dns = pick(args.cluster_dns, "cluster_dns", "")
        if cluster_addrs and cluster_dns:
            parser.error(
                "--cluster and cluster_dns are mutually exclusive -- a"
                " static list would silently shadow DNS-driven membership"
            )
        if cluster_addrs:
            hosts = HostList(static=cluster_addrs)
        elif cluster_dns:
            hosts = HostList.from_dns(
                cluster_dns, scheme="https" if ssl_context else ""
            )
        else:
            hosts = None
        ring = (
            Ring(hosts, max_replica=cfg.get("max_replica", 3))
            if hosts is not None
            else None
        )
        self_addr = pick(args.self_addr, "self_addr", "")
        if cluster_dns and not self_addr:
            parser.error("cluster_dns requires --self-addr")
        if cluster_dns and ring is not None and self_addr not in ring.members:
            logging.getLogger("kraken.cli").warning(
                "--self-addr %r is not among the DNS-resolved members %s; "
                "it must match the resolver's output format (ip:port%s)",
                self_addr, ring.members,
                ", https://ip:port with tls" if ssl_context else "",
            )
        if cluster_addrs and self_addr and self_addr not in cluster_addrs:
            parser.error(
                f"--self-addr {self_addr!r} does not appear in --cluster"
                " (must match one entry verbatim, or the origin will probe"
                " and replicate to itself)"
            )
        if cluster_addrs and not self_addr:
            self_addr = f"{host}:{port}" if port else ""
            if self_addr not in cluster_addrs:
                parser.error(
                    "--cluster requires --self-addr (or a fixed --port whose"
                    " host:port appears verbatim in --cluster)"
                )
        try:
            node = OriginNode(
                store_root=pick(args.store, "store", "./origin-store"),
                tracker_addr=pick(args.tracker, "tracker", ""),
                host=host,
                http_port=port,
                p2p_port=pick(args.p2p_port, "p2p_port", 0),
                hasher=hasher_of(),
                hash_workers=int(pick(args.hash_workers, "hash_workers", 1)),
                backends=backends,
                ring=ring,
                self_addr=self_addr,
                cleanup=cleanup,
                dedup_index=cfg.get("dedup_index", "dict"),
                dedup_budget_bytes=cfg.get("dedup_budget_bytes"),
                dedup_low_j_bands=cfg.get("dedup_low_j_bands"),
                scheduler_config_doc=scheduler_cfg,
                p2p_bandwidth=cfg.get("p2p_bandwidth"),
                ssl_context=ssl_context,
                durability=cfg.get("durability", "rename"),
                scrub=scrub_cfg,
                fsck=fsck_enabled,
                task_timeout_seconds=float(
                    cfg.get("task_timeout_seconds", 1800.0)
                ),
                rpc=rpc_cfg,
                resources=cfg.get("resources"),
                trace=cfg.get("trace"),
                delta=cfg.get("delta"),
                profiling=cfg.get("profiling"),
                chunkstore=cfg.get("chunkstore"),
                slo=cfg.get("slo"),
                ingest=cfg.get("ingest"),
                quorum=cfg.get("quorum"),
            )
        except ValueError as e:
            # A refused value (a hasher, a plane that waits): no READY.
            parser.error(str(e))
        asyncio.run(
            _run_until_signal(node, {"component": "origin"}, args.config)
        )

    elif args.component == "agent":
        # None = not requested; 0 = requested on an ephemeral port.
        registry_port = pick(args.registry_port, "registry_port", None)
        build_index = pick(args.build_index, "build_index", "")
        if registry_port is not None and not build_index:
            parser.error("--registry-port requires --build-index (tag"
                         " lookups resolve through it)")
        try:
            node = AgentNode(
                store_root=pick(args.store, "store", "./agent-store"),
                tracker_addr=pick(args.tracker, "tracker", ""),
                host=host,
                http_port=port,
                p2p_port=pick(args.p2p_port, "p2p_port", 0),
                registry_port=registry_port or 0,
                build_index_addr=build_index,
                hasher=hasher_of(),
                hash_workers=int(pick(args.hash_workers, "hash_workers", 1)),
                cleanup=cleanup,
                scheduler_config=(
                    SchedulerConfig.from_dict(scheduler_cfg)
                    if scheduler_cfg else None
                ),
                p2p_bandwidth=cfg.get("p2p_bandwidth"),
                ssl_context=ssl_context,
                tag_cache_ttl=float(cfg.get("tag_cache_ttl", 0.0)),
                durability=cfg.get("durability", "rename"),
                registry_strict_accept=bool(
                    cfg.get("registry_strict_accept", False)
                ),
                scrub=scrub_cfg,
                fsck=fsck_enabled,
                rpc=rpc_cfg,
                resources=cfg.get("resources"),
                trace=cfg.get("trace"),
                delta=cfg.get("delta"),
                profiling=cfg.get("profiling"),
                chunkstore=cfg.get("chunkstore"),
                slo=cfg.get("slo"),
                canary=cfg.get("canary"),
                ingest=cfg.get("ingest"),
                pex=cfg.get("pex"),
            )
        except ValueError as e:
            # A refused value (a hasher, a plane that waits): no READY.
            parser.error(str(e))
        asyncio.run(
            _run_until_signal(node, {"component": "agent"}, args.config)
        )

    elif args.component == "build-index":
        backends_cfg = cfg.get("backends")
        backends = BackendManager(backends_cfg) if backends_cfg else None
        remotes = [
            a for a in (pick(args.remotes, "remotes", "") or "").split(",") if a
        ]
        node = BuildIndexNode(
            store_root=pick(args.store, "store", "./build-index-store"),
            host=host,
            port=port,
            backends=backends,
            remotes=remotes or None,
            origin_cluster=origin_cluster(
                pick(args.origins, "origins", ""), "build-index"
            ),
            ssl_context=ssl_context,
            # YAML: immutable_tags: true -- a tag can never be re-pointed
            # at a different digest (same-digest re-push stays idempotent).
            immutable_tags=bool(cfg.get("immutable_tags", False)),
            task_timeout_seconds=float(
                cfg.get("task_timeout_seconds", 1800.0)
            ),
        )
        asyncio.run(_run_until_signal(node, {"component": "build-index"}))

    elif args.component == "proxy":
        cluster = origin_cluster(pick(args.origins, "origins", ""), "proxy")
        if cluster is None:
            parser.error("proxy requires --origins")
        build_index = pick(args.build_index, "build_index", "")
        if not build_index:
            parser.error("proxy requires --build-index")
        node = ProxyNode(
            cluster,
            build_index,
            host=host,
            port=port,
            ssl_context=ssl_context,
            spool_root=pick(args.spool, "spool", None),
        )
        asyncio.run(_run_until_signal(node, {"component": "proxy"}))


if __name__ == "__main__":
    main()
