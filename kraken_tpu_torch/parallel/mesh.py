"""Device mesh for the hash plane.

The port of ``kraken_tpu.parallel.mesh``. One axis -- ``pieces`` --
because the only parallel dimension SHA-256 admits is across pieces (the
64-round chain serializes the blocks of one piece). PyTorch has no
``Mesh``: :class:`PieceMesh` is the small frozen record that stands in for
one, the devices of the axis in order.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS = "pieces"


@dataclasses.dataclass(frozen=True)
class PieceMesh:
    """A 1-D mesh: ``devices`` in shard order on the axis ``axis_names[0]``.

    A ``cpu`` mesh repeats ``torch.device("cpu")``: its entries are
    logical shards, the counterpart of the JAX package's virtual CPU
    devices, which torch does not have."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def piece_mesh(n_devices: int | None = None, platform: str | None = None) -> PieceMesh:
    """Build a 1-D ``pieces`` mesh.

    ``platform=None`` means the card: every visible CUDA device, or the
    first ``n_devices`` of them. It raises when CUDA is absent or has fewer
    devices than asked for; unlike the reference it never falls back to
    CPU shards, which would hide that the card is missing.
    ``platform="cpu"`` gives ``n_devices`` (default 1) logical CPU shards,
    on which the kernels' plain versions run.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device: {n_devices}")
    if platform == "cpu":
        return PieceMesh((torch.device("cpu"),) * (n_devices or 1))
    if platform not in (None, "cuda"):
        raise ValueError(f"platform must be None, 'cuda' or 'cpu': {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "piece_mesh needs a CUDA device; pass platform='cpu' for a mesh "
            "of CPU shards that runs the plain PyTorch versions"
        )
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return PieceMesh(tuple(torch.device("cuda", i) for i in range(n)))
