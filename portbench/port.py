"""What the bench takes from the port besides the system under test: the
CPU request for a rehearsal, the counters it reads, and the shipped YAML of
a node. Nothing here is imported before a driver runs."""

from __future__ import annotations

from portbench.harness import ROOT


def ask_for_cpu() -> None:
    """A rehearsal asks the port for the CPU explicitly: the ``cuda`` hasher
    becomes the kernels' plain PyTorch version (``device="cpu"``)."""
    from kraken_tpu_torch.core.hasher import register_hasher
    from kraken_tpu_torch.ops.sha256 import TorchPieceHasher

    register_hasher("cuda", lambda: TorchPieceHasher(device="cpu"))


def counters() -> dict[str, float]:
    """The port's counters that per-layer metrics read, now."""
    from kraken_tpu_torch.ops import sha256_cuda
    from kraken_tpu_torch.utils.metrics import REGISTRY

    c = REGISTRY.counter
    out = {
        "verify_pieces": c("verify_pieces_total").value(),
        "verify_flushes_cuda": c("verify_batches_total").value(path="cuda"),
        "verify_flushes_host": c("verify_batches_total").value(path="host"),
        "rows_hashed": c("hasher_pieces_total").value(hasher="cuda"),
        "bytes_hashed": c("hasher_bytes_total").value(hasher="cuda"),
        "bytes_down": c("p2p_piece_bytes_down_total").value(),
        "ingest_fallbacks": c("ingest_fallbacks_total").value(),
    }
    out.update({f"launches.{k}": float(v) for k, v in sha256_cuda.LAUNCHES.items()})
    return out


def rise(before: dict[str, float], after: dict[str, float]) -> dict[str, float]:
    return {k: after[k] - before[k] for k in after}


def node_yaml(config: dict) -> dict:
    """The node's shipped YAML (``extends`` resolved) with the
    configuration's ``overrides`` on top."""
    from kraken_tpu_torch.configutil import load_config

    doc = load_config(str(ROOT / config["yaml"]))
    doc.update(config.get("overrides", {}))
    return doc


def memory_peak_bytes(cpu: bool) -> int:
    if cpu:
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())
