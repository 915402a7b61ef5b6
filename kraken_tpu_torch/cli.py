"""Component entry points: one long-running process per component.

The port's copy of the ``tracker``, ``origin``, ``agent``, ``build-index``,
``proxy``, ``status``, ``trace``, ``flame`` and ``promgen`` subcommands of
``kraken_tpu.cli``:

    python -m kraken_tpu_torch.cli tracker     --config config/tracker/development.yaml
    python -m kraken_tpu_torch.cli origin      --config config/origin/development.yaml --hasher cuda
    python -m kraken_tpu_torch.cli agent       --config config/agent/development.yaml --hasher cuda \
                                               --registry-port 0 --build-index host:7620
    python -m kraken_tpu_torch.cli build-index --config config/build-index/base.yaml --store ./bi \
                                               --origins host:7610
    python -m kraken_tpu_torch.cli proxy       --config config/proxy/base.yaml \
                                               --origins host:7610 --build-index host:7620
    python -m kraken_tpu_torch.cli status      --nodes host:7601,host:7602,host:7610
    python -m kraken_tpu_torch.cli trace       agent-dump.jsonl tracker-dump.jsonl origin-dump.jsonl
    python -m kraken_tpu_torch.cli flame       profile-*.jsonl
    python -m kraken_tpu_torch.cli promgen     --out deploy/prometheus

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

``status`` scrapes each node's ``/debug/`` mux and exits 0 (every node
healthy), 1 (one burning: a firing burn-rate alert, a latched resource
breach, a failing ``/health``), 2 (one unreachable) or 3 (usage); ``trace``
joins flight-recorder dumps into span trees (exit 1 on a propagation
break); ``flame`` folds profile dumps (exit 1 on an unparseable or
truncated file); ``promgen`` writes ``deploy/prometheus/``.
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
    "scrub": "A7h",
    "fsck": "A7h",
    "lint": "A7h",
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


def run_trace_tool(paths: list[str], trace_id: str | None = None,
                   slowest: int = 0) -> int:
    """`trace`: reassemble flight-recorder JSONL dumps
    offline (multi-node -- pass every node's dump to join a cross-node
    trace) and print indented span trees, critical path marked with
    ``*``. Returns the process exit code: 0 joined clean, 1 when any
    span is an ORPHAN (its parent_id names a span absent from the set:
    a hop dropped the context, or a node's dump is missing -- CI gates
    on this), 3 usage error. In-process callable for tests."""
    from kraken_tpu_torch.utils.trace import (
        assemble_tree,
        critical_path,
        format_tree,
        load_dumps,
    )

    try:
        by_trace = load_dumps(paths)
    except OSError as e:
        print(json.dumps({"event": "error", "message": str(e)}), flush=True)
        return 3
    if trace_id is not None:
        if trace_id not in by_trace:
            print(json.dumps({
                "event": "error",
                "message": f"trace {trace_id} not found in dumps",
            }), flush=True)
            return 1
        by_trace = {trace_id: by_trace[trace_id]}

    def span_end(s: dict) -> float:
        return s.get("start_ts", 0.0) + s.get("duration_s", 0.0)

    def trace_duration(spans: list[dict]) -> float:
        if not spans:
            return 0.0
        return max(span_end(s) for s in spans) - min(
            s.get("start_ts", 0.0) for s in spans
        )

    ordered = sorted(
        by_trace.items(), key=lambda kv: trace_duration(kv[1]), reverse=True
    )
    if slowest > 0:
        ordered = ordered[:slowest]

    total_orphans = 0
    for tid, spans in ordered:
        roots, orphans = assemble_tree(spans)
        total_orphans += len(orphans)
        nodes = sorted({s.get("node", "") for s in spans if s.get("node")})
        errored = sum(1 for s in spans if s.get("status") == "error")
        print(
            f"trace {tid}  spans={len(spans)}"
            f"  duration={trace_duration(spans) * 1e3:.1f}ms"
            f"  nodes={','.join(nodes) or '-'}"
            + (f"  errors={errored}" if errored else "")
        )
        for root in roots:
            for line in format_tree(root, critical_path(root)):
                print(line)
        for s in orphans:
            print(
                f"! ORPHAN {s.get('name', '?')} span={s.get('span_id')}"
                f" parent={s.get('parent_id')} -- parent span missing"
                f" from the dump set (propagation break or absent node"
                f" dump)"
            )
        print()
    print(json.dumps({
        "event": "trace_done",
        "traces": len(ordered),
        "orphans": total_orphans,
    }), flush=True)
    return 1 if total_orphans else 0


def run_flame_tool(paths: list[str], top: int = 0) -> int:
    """`flame`: fold one or more profile JSONL dumps
    (utils/profiler.py -- written by the flight-recorder triggers or
    GET /debug/pprof/profile saved to disk; worker-shard samples ship
    through the parent, so ONE node dump already covers main loop plus
    shards) into a single flamegraph-ready collapse on stdout
    (``node;thread;frames... count``), with the data-plane split
    (pump/verify/pwrite/serve/...) quantified in a trailing JSON line.
    Exit codes mirror `trace`'s orphan gate: 0 clean, 1 when
    any file is unparseable or TRUNCATED (its header promised more
    stacks than the file holds -- a torn capture must fail CI loudly,
    not quietly thin the flamegraph), 3 usage (no input readable at
    all). In-process callable for tests."""
    from kraken_tpu_torch.utils.profiler import load_profile_dumps, plane_pct_busy

    stacks, planes, errors = load_profile_dumps(paths)
    if not stacks and not planes and errors:
        # Nothing at all was usable (unreadable paths, files with no
        # profile header): a typo'd glob must not "fold clean". A
        # truncated-but-headed dump still folds what survived -- and
        # exits 1 below.
        for err in errors:
            print(json.dumps({"event": "error", "message": err}),
                  flush=True)
        return 3
    ordered = stacks.most_common(top if top > 0 else None)
    for stack, count in ordered:
        print(f"{stack} {count}")
    for err in errors:
        print(json.dumps({"event": "error", "message": err}), flush=True)
    print(json.dumps({
        "event": "flame_done",
        "files": len(paths),
        "stacks": len(stacks),
        "samples": sum(stacks.values()),
        "planes": dict(planes),
        "plane_pct_busy": plane_pct_busy(planes),
        "errors": len(errors),
    }), flush=True)
    return 1 if errors else 0


def run_status_tool(nodes: list[str], timeout_seconds: float = 5.0) -> int:
    """`status`: the operator's fleet-wide entry point.
    Scrapes ``/debug/`` (surface index), ``/health``, ``/debug/slo``,
    ``/debug/healthcheck``, and ``/debug/resources`` from every node in
    the list and prints one table row per node plus a JSON summary
    line.  Exit codes are the deploy-gate contract (docs/OPERATIONS.md
    "SLO & canary"): **0** every node healthy, **1** at least one node
    burning (a firing burn-rate alert, a latched resource breach, or a
    draining/unhealthy /health), **2** at least one node unreachable
    (unreachability dominates: a gate cannot call a fleet it cannot
    see healthy), **3** usage error.  In-process callable for tests."""
    from kraken_tpu_torch.utils.httputil import HTTPClient, base_url

    if not nodes:
        print(json.dumps({
            "event": "error", "message": "status requires --nodes",
        }), flush=True)
        return 3

    async def scrape_node(http: HTTPClient, addr: str) -> dict:
        row: dict = {"addr": addr, "reachable": True, "burning": []}

        async def get_json(path: str):
            body = await http.get(
                f"{base_url(addr)}{path}", retry_5xx=False
            )
            return json.loads(body)

        # The index answers "what does this node serve" -- and is the
        # reachability probe (every instrumented mux has it).
        try:
            index = await get_json("/debug/")
        except Exception as e:
            row["reachable"] = False
            row["error"] = repr(e)
            return row
        row["component"] = index.get("component", "?")
        surfaces = set(index.get("surfaces", {}))
        # /health: 503 = draining (lameduck) or refusing -- burning.
        # Gated on the index: the proxy's registry app serves no
        # /health route, and a 404 there is not an unhealthy fleet.
        if "/health" in surfaces:
            try:
                await http.get(f"{base_url(addr)}/health", retry_5xx=False)
                row["health"] = "ok"
            except Exception:
                row["health"] = "unhealthy"
                row["burning"].append("health")
        else:
            row["health"] = "n/a"
        if "/debug/slo" in surfaces:
            try:
                slo = await get_json("/debug/slo")
                row["slo_firing"] = slo.get("firing", [])
                for alert in row["slo_firing"]:
                    row["burning"].append(
                        f"slo:{alert['sli']}:{alert['severity']}"
                    )
                canary = slo.get("canary")
                if canary:
                    # A verdict older than a few probe intervals is
                    # history, not state: a prober disabled right
                    # after one failure must not gate deploys red
                    # until the process restarts.  The AGE is computed
                    # node-side (/debug/slo stamps it on its own
                    # clock), so status-machine clock skew cannot
                    # flip fresh verdicts stale or vice versa.
                    age = canary.get("age_seconds", 0.0)
                    stale = age > 3 * canary.get(
                        "interval_seconds", 60.0
                    ) + 60.0
                    row["canary"] = {
                        "result": canary.get("result"),
                        "seq": canary.get("seq"),
                        "stale": stale,
                    }
                    if (
                        canary.get("result") not in (None, "ok")
                        and not stale
                    ):
                        row["burning"].append(
                            f"canary:{canary['result']}"
                        )
                # Budget exhaustion is burning even between alert
                # windows: a negative budget means the objective is
                # already broken for this compliance window.
                for sli, doc in (
                    slo.get("last_eval", {}).get("slis", {})
                ).items():
                    if doc.get("budget_remaining", 1.0) < 0.0:
                        row["burning"].append(f"budget:{sli}")
            except Exception as e:
                row["burning"].append("slo_unreadable")
                row["slo_error"] = repr(e)
        if "/debug/resources" in surfaces:
            try:
                res = await get_json("/debug/resources")
                latched = [
                    name
                    for name, snap in res.get("sentinels", {}).items()
                    if snap.get("breach_latched")
                ]
                if latched:
                    row["burning"].append("resources")
                    row["resource_breaches"] = latched
            except Exception:
                row["burning"].append("resources_unreadable")
        if "/debug/healthcheck" in surfaces:
            try:
                hc = await get_json("/debug/healthcheck")
                unhealthy = sorted({
                    host
                    for snap in hc.values()
                    for host, h in (snap.get("hosts") or {}).items()
                    if h.get("state") == "open" or h.get("browned_out")
                })
                if unhealthy:
                    # A tripped breaker on a DOWNSTREAM is context, not
                    # this node's burn -- report, don't gate.
                    row["downstream_unhealthy"] = unhealthy
            except Exception:
                # Context-only surface: unreadable must not gate, but
                # the operator should see WHY the column is absent.
                row["healthcheck_unreadable"] = True
        return row

    async def main() -> list[dict]:
        http = HTTPClient(retries=0, timeout_seconds=timeout_seconds)
        try:
            return list(await asyncio.gather(*(
                scrape_node(http, a) for a in nodes
            )))
        finally:
            await http.close()

    rows = asyncio.run(main())
    header = f"{'NODE':<24} {'COMPONENT':<12} {'HEALTH':<10} STATUS"
    print(header)
    for row in rows:
        if not row["reachable"]:
            print(f"{row['addr']:<24} {'?':<12} {'UNREACHABLE':<10} "
                  f"{row.get('error', '')}")
            continue
        status = ",".join(row["burning"]) or "healthy"
        extra = ""
        if row.get("downstream_unhealthy"):
            extra = (
                "  downstream_unhealthy="
                + ",".join(row["downstream_unhealthy"])
            )
        if row.get("healthcheck_unreadable"):
            # Context-only (never gates), but the operator must see WHY
            # the downstream column is absent for this node.
            extra += "  healthcheck=unreadable"
        canary = row.get("canary")
        if canary:
            extra += f"  canary={canary['result']}#{canary['seq']}"
        print(
            f"{row['addr']:<24} {row.get('component', '?'):<12} "
            f"{row['health']:<10} {status}{extra}"
        )
    unreachable = [r["addr"] for r in rows if not r["reachable"]]
    burning = [r["addr"] for r in rows if r.get("burning")]
    code = 2 if unreachable else (1 if burning else 0)
    print(json.dumps({
        "event": "status_done",
        "nodes": len(rows),
        "unreachable": unreachable,
        "burning": burning,
        "exit_code": code,
    }), flush=True)
    return code


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
                               " scheduler.data_plane_workers): inbound"
                               " seed conns are fd-passed to them and"
                               " pieces go out via sendfile, off the main"
                               " loop; 0 = single-loop serving")

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
                              " scheduler.data_plane_workers); a completed"
                              " agent seeds its swarm off the download loop")
    p_agent.add_argument("--leech-workers", type=int, default=None,
                         help="download-pump worker processes (overrides"
                              " scheduler.leech_workers); active downloads"
                              " move their recv+parse+pwrite off the main"
                              " loop, verify stays batched in the parent"
                              " (on the card with the cuda hasher)")

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

    p_trace = sub.add_parser(
        "trace", help="offline flight-recorder reassembly: read one or"
        " more trace dump JSONL files (multi-node), join spans by"
        " trace_id, and print indented span trees with durations and"
        " the critical path marked; exit 1 when any span names a parent"
        " absent from the set (a propagation break -- CI gates on it),"
        " 3 on usage errors"
    )
    p_trace.add_argument("dumps", nargs="+",
                         help="flight-recorder JSONL dump files (from"
                              " /debug/trace dump triggers; combine"
                              " dumps from several nodes to join a"
                              " cross-node trace)")
    p_trace.add_argument("--trace-id", default=None,
                         help="print only this trace (exit 1 if absent"
                              " from the dumps)")
    p_trace.add_argument("--slowest", type=int, default=0,
                         help="print only the N slowest traces")

    p_flame = sub.add_parser(
        "flame", help="offline continuous-profiling reassembly: fold one"
        " or more profile JSONL dumps (from the flight-recorder triggers"
        " or /debug/pprof/profile) into a flamegraph-ready collapse with"
        " the data-plane split (pump/verify/pwrite/serve) quantified;"
        " exit 1 when any file is unparseable or truncated (CI gates on"
        " it), 3 when no input is usable"
    )
    p_flame.add_argument("dumps", nargs="+",
                         help="profile JSONL dump files (profile-*.jsonl"
                              " from <store>/traces/; one node dump"
                              " already folds main loop + worker shards)")
    p_flame.add_argument("--top", type=int, default=0,
                         help="print only the N hottest stacks")

    p_status = sub.add_parser(
        "status", help="fleet-wide SLO/health aggregator: scrape"
        " /debug/, /debug/slo, /debug/healthcheck, /debug/resources"
        " and /health across a node list into one table; exit 0 every"
        " node healthy / 1 at least one burning (firing burn-rate"
        " alert, latched resource breach, failing health) / 2 at least"
        " one unreachable / 3 usage -- deploy gates run it before and"
        " after a rollout step"
    )
    # NOT argparse-required: a missing --nodes must exit 3 (usage),
    # never argparse's default 2 -- the deploy-gate contract reserves
    # 2 for "unreachable" (retryable infra, not a script bug).
    p_status.add_argument("--nodes", default="",
                          help="comma-separated host:port list (every"
                               " component type; the /debug/ index"
                               " tells the tool what each node serves)")
    p_status.add_argument("--timeout", type=float, default=5.0,
                          help="per-request scrape timeout in seconds")

    p_promgen = sub.add_parser(
        "promgen", help="regenerate deploy/prometheus/ (scrape config +"
        " burn-rate alert rules) from the shipped SLO defaults; CI"
        " gates the committed files against a fresh generation"
    )
    p_promgen.add_argument("--out", default="deploy/prometheus",
                           help="output directory")

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

    # The offline tools: no node, no config.
    if args.component == "trace":
        sys.exit(run_trace_tool(args.dumps, trace_id=args.trace_id,
                                slowest=args.slowest))
    if args.component == "flame":
        sys.exit(run_flame_tool(args.dumps, top=args.top))
    if args.component == "status":
        nodes = [a.strip() for a in (args.nodes or "").split(",") if a.strip()]
        sys.exit(run_status_tool(nodes, timeout_seconds=args.timeout))
    if args.component == "promgen":
        from kraken_tpu_torch.utils.promgen import write_files

        for path in write_files(args.out):
            print(json.dumps({"event": "generated", "path": path}), flush=True)
        return

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
