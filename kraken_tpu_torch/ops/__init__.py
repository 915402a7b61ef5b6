"""GPU compute plane: batched SHA-256, the FastCDC gear pass (hand-written
CUDA kernels for Hopper, each beside its plain PyTorch version) and MinHash
sketching (plain PyTorch on the index's device).

The counterpart of ``kraken_tpu.ops``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None, what: str) -> torch.device:
    """An entry point's device: ``None`` means the card, and a card that is
    not there raises; ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} needs a CUDA device; pass device='cpu' for the plain "
            "PyTorch version"
        )
    return dev


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, (x - 1).bit_length())
