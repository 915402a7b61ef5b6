"""The readers of the SHA-256 plane's stage timers and the dispatcher's
re-requests against hand figures, taken from a registry filled by hand,
and ``None`` where a run holds nothing to read: a denominator that is 0,
or a program without the counters (the parent's registry)."""

import pytest

from kraken_tpu_torch.utils.metrics import Registry
from portbench import plane
from portbench.harness import load_reader

# (counter, labels, value) as a program with the stage timers holds them.
FILLED = [
    ("verify_pieces_total", {}, 40.0),
    ("verify_batches_total", {"path": "cuda"}, 32.0),
    ("hash_plane_seconds_total", {"path": "verify", "stage": "queue"}, 0.06),
    ("hash_plane_seconds_total", {"path": "verify", "stage": "pool"}, 0.02),
    ("hash_plane_seconds_total", {"path": "verify", "stage": "check"}, 1.6),
    ("hash_plane_seconds_total", {"path": "verify", "stage": "readback"}, 3.2),
    ("p2p_piece_rerequests_total", {"reason": "expired"}, 1.0),
    ("p2p_piece_rerequests_total", {"reason": "endgame"}, 1.0),
    ("hash_plane_seconds_total", {"path": "ingest", "stage": "slot"}, 1.44),
    ("hash_plane_events_total", {"path": "ingest", "stage": "slot"}, 16.0),
    ("hash_plane_seconds_total", {"path": "ingest", "stage": "stage"}, 0.32),
    ("hash_plane_seconds_total", {"path": "ingest", "stage": "submit"}, 0.0032),
    ("hash_plane_events_total", {"path": "ingest", "stage": "stage"}, 16.0),
]

CASES = [
    # (0.06 + 0.02) s over 40 pieces = 2 ms a piece
    ("verify.wait_ms_per_piece.steady", 2.0, "verify_pieces_total"),
    # (1.6 + 3.2) s over 32 flushes = 150 ms a flush
    ("verify.sync_ms_per_flush.steady", 150.0, "verify_batches_total"),
    # 2 re-requests over 40 pieces
    ("p2p.rerequests_per_piece.steady", 0.05, "verify_pieces_total"),
    # 1.44 s over 16 slot waits = 90 ms a window
    ("ingest.slot_wait_ms_per_window.regen", 90.0, "hash_plane_events_total"),
    # (0.32 + 0.0032) s over 16 windows = 20.2 ms a window
    ("ingest.host_ms_per_window.regen", 20.2, "hash_plane_events_total"),
]


def registry(skip: str | None = None, bare: bool = False) -> Registry:
    """A registry filled by hand, without the counter ``skip``'s values;
    ``bare`` registers only what the parent program has."""
    reg = Registry()
    for name, labels, v in FILLED:
        if bare and (name.startswith("hash_plane_") or name.startswith("p2p_piece_rerequests")):
            continue
        c = reg.counter(name)
        if name != skip:
            c.inc(v, **labels)
    return reg


@pytest.mark.parametrize("name,want,den", CASES, ids=[c[0] for c in CASES])
def test_a_plane_reader_gives_the_hand_figure_or_none(name, want, den, monkeypatch):
    read = load_reader(name)
    real = plane.totals
    for reg, expect in ((registry(), want), (registry(skip=den), None),
                        (registry(bare=True), None)):
        monkeypatch.setattr(plane, "totals", lambda reg=reg: real(reg))
        got = read({"counters": {"window": {}}})
        assert got == (pytest.approx(expect) if expect is not None else None)
