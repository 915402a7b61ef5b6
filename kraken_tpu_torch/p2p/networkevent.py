"""Structured swarm tracing: JSONL network events for offline analysis.

Mirrors uber/kraken ``lib/torrent/networkevent`` (every swarm event --
conn open/close, piece request/receive/send, blacklist -- emitted as
structured JSON to a dedicated sink for swarm reconstruction) -- upstream
path, unverified; SURVEY.md SS5.
"""

from __future__ import annotations

import json
import logging
import time
from typing import IO, Optional

from kraken_tpu_torch.utils import trace

_log = logging.getLogger("kraken.networkevent")
_sink_failures = None  # lazy FailureMeter: metrics import cycles at module load


class Name:
    ADD_TORRENT = "add_torrent"
    ADD_ACTIVE_CONN = "add_active_conn"
    DROP_ACTIVE_CONN = "drop_active_conn"
    BLACKLIST_CONN = "blacklist_conn"
    REQUEST_PIECE = "request_piece"
    RECEIVE_PIECE = "receive_piece"
    TORRENT_COMPLETE = "torrent_complete"
    # One structured line per completed download with the operative
    # numbers (pieces, peers used, bytes up/down, duration, blacklist
    # events) -- the reference's per-torrent torrentlog summary, riding
    # the same JSONL stream so offline swarm analysis gets lifecycle
    # rollups without re-deriving them from the piece events.
    TORRENT_SUMMARY = "torrent_summary"
    ANNOUNCE = "announce"


class Producer:
    """Writes one JSON object per line to ``sink`` (a file-like) or, with
    ``sink=None``, keeps an in-memory ring for tests."""

    def __init__(self, peer_id: str, sink: Optional[IO[str]] = None, keep: int = 10000):
        self._peer_id = peer_id
        self._sink = sink
        self._events: list[dict] = []
        self._keep = keep

    def emit(self, name: str, info_hash: str = "", **fields) -> None:
        event = {
            "name": name,
            "ts": time.time(),
            "self": self._peer_id,
            "info_hash": info_hash,
            **fields,
        }
        # Events emitted under an active span carry its trace id, so
        # offline swarm reconstructions (JSONL) join the distributed
        # traces -- the one key that connects the two planes.
        ids = trace.current_ids()
        if ids is not None:
            event["trace_id"] = ids[0]
        if self._sink is not None:
            # Tracing must never affect the data plane: a full disk or a
            # closed sink is an observability failure, not peer
            # misbehavior (an emit raising inside a dispatcher io task
            # would blacklist an innocent peer).
            try:
                self._sink.write(
                    json.dumps(event, separators=(",", ":")) + "\n"
                )
            except Exception as e:
                # ...but a full disk / closed sink must still be SEEN:
                # counted + one throttled WARN, never a per-event flood.
                global _sink_failures
                if _sink_failures is None:
                    from kraken_tpu_torch.utils.metrics import FailureMeter

                    _sink_failures = FailureMeter(
                        "network_event_sink_errors_total",
                        "Network-event JSONL writes that raised (full"
                        " disk / closed sink); events were dropped",
                        _log,
                    )
                _sink_failures.record("network event sink write", e)
        else:
            self._events.append(event)
            if len(self._events) > self._keep:
                del self._events[: -self._keep]

    @property
    def events(self) -> list[dict]:
        return list(self._events)


class NoopProducer(Producer):
    def __init__(self):
        super().__init__("")

    def emit(self, name: str, info_hash: str = "", **fields) -> None:
        pass
