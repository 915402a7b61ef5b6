"""Wrappers of the hand-written SHA-256 kernels (``csrc/``).

Two wrappers launch the kernel of ``csrc/sha256.cu``, ``sha256_rows``:

- :func:`sha256_uniform` -- M equal-length pieces ``[M, P]`` uint8, the
  counterpart of ``kraken_tpu/ops/sha256_pallas.py`` ``sha256_tiles`` (the
  origin's metainfo generation). Rows are not padded up to a tile: the grid
  is ``ceil(M / 128)`` blocks.
- :func:`sha256_ragged` -- rows of any length in one flat buffer, given by
  offsets and lengths, the counterpart of ``kraken_tpu/ops/sha256.py``
  ``_sha256_ragged`` (the agent's verify). The host does no SHA padding.

Two launch the kernels of ``csrc/sha256_packed.cu``, the packed path of the
ingest plane (``core/ingest.py``):

- :func:`pack_tiles_device` -- natural ``[M, P]`` uint8 pieces to the
  packed word-major ``[T, NB, 16, 8, 128]`` layout, the counterpart of
  ``kraken_tpu/ops/sha256_pallas.py`` ``pack_tiles_device``;
- :func:`sha256_packed_tiles` -- SHA-256 of the pieces of packed tiles,
  the counterpart of ``sha256_pallas.py`` ``sha256_packed_tiles``.

:func:`hash_pieces_device_packed` chains the two for any row count.
What bounds each kernel, and what its design does about it, is noted at
the top of its source.

A tensor on the CPU goes through the plain PyTorch version
(:mod:`kraken_tpu_torch.ops.sha256_ref`); a CUDA tensor
launches the kernel or raises. The kernels live in the port's one kernel
library, built at first use (:mod:`kraken_tpu_torch.ops.cuda_lib`).

``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from kraken_tpu_torch.ops import cuda_lib
from kraken_tpu_torch.ops.sha256_ref import (
    N_TILE,
    pack_tiles_ref,
    packed_nb,
    sha256_packed_ref,
    sha256_rows_ref,
    sha256_uniform_ref,
    uniform_rows,
)

LAUNCHES = {
    "sha256_uniform": 0, "sha256_ragged": 0,
    "pack_tiles_device": 0, "sha256_packed_tiles": 0,
}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sha256 takes cpu or cuda tensors, got {t.device}")


def _run(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``entry(*args, stream)`` on ``device``'s
    current stream, raise if the launch was refused, and count it under
    ``name``."""
    cuda_lib.launch(entry, device, *args)
    with _lock:
        LAUNCHES[name] += 1


def _launch(
    name: str, flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    n = lengths.numel()
    out = torch.empty((n, 8), dtype=torch.int32, device=flat.device)
    if n:
        _run(
            name, "sha256_rows_launch", flat.device, flat.data_ptr(),
            offsets.data_ptr(), lengths.data_ptr(), n, out.data_ptr(),
        )
    return out


def sha256_ragged(
    flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """SHA-256 of each row ``flat[offsets[i] : offsets[i] + lengths[i]]``.

    ``flat``: 1-D uint8; ``offsets``, ``lengths``: 1-D int64, N rows, on
    the same device. Returns [N, 8] int32 digest words (uint32 bit
    patterns). Rows whose start is 16-byte aligned load 128 bits at a
    time."""
    _check_device(flat)
    if flat.dim() != 1 or flat.dtype != torch.uint8 or not flat.is_contiguous():
        raise ValueError("flat must be a contiguous 1-D uint8 tensor")
    for name, t in (("offsets", offsets), ("lengths", lengths)):
        if t.dim() != 1 or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, flat on {flat.device}")
    if offsets.numel() != lengths.numel():
        raise ValueError(
            f"{offsets.numel()} offsets for {lengths.numel()} lengths"
        )
    if lengths.numel() and bool(
        ((offsets < 0) | (lengths < 0) | (offsets + lengths > flat.numel())).any()
    ):
        raise ValueError("a row lies outside flat")
    if flat.device.type == "cpu":
        return sha256_rows_ref(flat, offsets, lengths)
    return _launch("sha256_ragged", flat, offsets, lengths)


def sha256_uniform(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of ``rows`` ([M, P] uint8, contiguous, any P).
    Returns [M, 8] int32 digest words (uint32 bit patterns)."""
    _check_device(rows)
    if rows.dim() != 2 or rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D uint8 tensor")
    if rows.device.type == "cpu":
        return sha256_uniform_ref(rows)
    return _launch("sha256_uniform", *uniform_rows(rows))


def pack_tiles_device(rows: torch.Tensor, unpadded_blocks: int) -> torch.Tensor:
    """The relayout of the packed path: natural [M, P] uint8 pieces
    (contiguous, M % 1024 == 0, P = ``unpadded_blocks`` * 64) -> the packed
    [T, NB, 16, 8, 128] int32 big-endian words, NB =
    ``packed_nb(unpadded_blocks)``, blocks past the piece's own zero."""
    _check_device(rows)
    if rows.dim() != 2 or rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D uint8 tensor")
    m, p = rows.shape
    if m % N_TILE or unpadded_blocks < 1 or p != unpadded_blocks * 64:
        raise ValueError(
            f"pack needs M % {N_TILE} == 0 and P == 64 * unpadded_blocks: "
            f"got [{m}, {p}], unpadded_blocks {unpadded_blocks}"
        )
    if rows.device.type == "cpu":
        return pack_tiles_ref(rows, unpadded_blocks)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned")
    nbp = packed_nb(unpadded_blocks)
    out = torch.empty(
        (m // N_TILE, nbp, 16, 8, 128), dtype=torch.int32, device=rows.device
    )
    if m:
        _run(
            "pack_tiles_device", "pack_tiles_launch", rows.device,
            rows.data_ptr(), m, p, nbp, out.data_ptr(),
        )
    return out


def sha256_packed_tiles(packed: torch.Tensor, unpadded_blocks: int) -> torch.Tensor:
    """SHA-256 of the ``T * 1024`` pieces in ``packed`` ([T, NB, 16, 8, 128]
    int32 big-endian words, contiguous), each ``unpadded_blocks`` 64-byte
    blocks long (NB >= unpadded_blocks; later blocks are never read).
    Returns [T * 1024, 8] int32 digest words in piece order."""
    _check_device(packed)
    if (
        packed.dim() != 5 or tuple(packed.shape[2:]) != (16, 8, 128)
        or packed.dtype != torch.int32 or not packed.is_contiguous()
    ):
        raise ValueError("packed must be a contiguous [T, NB, 16, 8, 128] int32 tensor")
    t, nbp = packed.shape[:2]
    if not 1 <= unpadded_blocks <= nbp:
        raise ValueError(f"unpadded_blocks {unpadded_blocks} outside 1..{nbp}")
    if packed.device.type == "cpu":
        return sha256_packed_ref(packed, unpadded_blocks)
    n = t * N_TILE
    out = torch.empty((n, 8), dtype=torch.int32, device=packed.device)
    if n:
        _run(
            "sha256_packed_tiles", "sha256_packed_launch", packed.device,
            packed.data_ptr(), n, nbp, unpadded_blocks, out.data_ptr(),
        )
    return out


def hash_pieces_device_packed(rows: torch.Tensor, piece_length: int) -> torch.Tensor:
    """The ``pack: device`` hash of [M, piece_length] uint8 pieces, any M:
    rows are padded with zero pieces up to a whole tile, packed on the
    device and hashed; returns the [M, 8] int32 digest words of the real
    rows."""
    if piece_length <= 0 or piece_length % 64:
        raise ValueError(f"piece_length must be a positive multiple of 64: {piece_length}")
    m = rows.shape[0]
    pad = (-m) % N_TILE
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
    nb = piece_length // 64
    return sha256_packed_tiles(pack_tiles_device(rows, nb), nb)[:m]
