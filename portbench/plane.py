"""Arithmetic of the metrics that read the SHA-256 plane's stage timers
and the dispatcher's re-requests.

``port.counters()`` does not hold these counters, so the readers take the
program's totals from its registry when the run has ended: they cover the
whole run, set-up's warm-up included (and, in the agent cell, the pulls
that settle after the window and the liar's image), not the window's rise
alone. A program without the counters gives no totals, and each reader
then returns ``None``."""

from __future__ import annotations

STAGES = ("queue", "pool", "slot", "stage", "check", "submit", "readback")


def totals(registry=None) -> dict[str, float]:
    """The plane's seconds (``plane_s.<path>.<stage>``) and events
    (``plane_n.<path>.<stage>``), ``rerequests`` (every reason) and the
    denominators beside them (``verify_pieces``, ``verify_flushes_cuda``),
    now; empty where the program does not register the stage timers."""
    if registry is None:
        from kraken_tpu_torch.utils.metrics import REGISTRY as registry

    names = set(registry.names())
    if "hash_plane_seconds_total" not in names:
        return {}
    c = registry.counter
    out = {"verify_pieces": c("verify_pieces_total").value(),
           "verify_flushes_cuda": c("verify_batches_total").value(path="cuda")}
    for path in ("verify", "ingest"):
        for stage in STAGES:
            out[f"plane_s.{path}.{stage}"] = c("hash_plane_seconds_total").value(
                path=path, stage=stage)
            out[f"plane_n.{path}.{stage}"] = c("hash_plane_events_total").value(
                path=path, stage=stage)
    if "p2p_piece_rerequests_total" in names:
        out["rerequests"] = sum(c("p2p_piece_rerequests_total").value(reason=r)
                                for r in ("expired", "rescue", "endgame"))
    return out


def per(c: dict[str, float], nums: tuple[str, ...], den: str,
        scale: float = 1.0) -> float | None:
    """``scale`` x the ``nums`` summed over ``den`` in the totals ``c``;
    None when a key is missing or the denominator is 0."""
    if not c.get(den) or any(k not in c for k in nums):
        return None
    return scale * sum(c[k] for k in nums) / c[den]
