"""Wrappers of the hand-written relayout diagnostic (``csrc/transpose.cu``).

Both compute one function: for each piece of ``[M, P]`` uint8 rows, the XOR
of its big-endian words by word index mod 8, as ``[M / 1024, 8, 8, 128]``
words. Neither is on a path of the system:
:mod:`kraken_tpu_torch.bench.transpose` times them beside the natural and
the packed hash.

- :func:`transpose_only` launches ``transpose_only_kernel``, the
  counterpart of ``bench_transpose.py:80`` ``transpose_only``: the fold at
  the card's memory rate (segments of every piece spread over all SMs,
  coalesced streaming loads, one ``atomicXor`` a word a segment into an
  output the launch zeroes first).
- :func:`natural_loads_only` launches ``natural_loads_kernel``, which
  replaces no TPU kernel: the natural SHA-256 kernel's own loads (one
  thread a piece, its ``cp.async`` block ring), folded where that kernel
  compresses, so that the decomposition's loads leg is the natural
  kernel's.

What bounds both: bytes -- P read and 32 written per piece, two integer
operations a word. The full notes are at the top of each kernel's source.

A tensor on the CPU goes through the plain PyTorch version
(:func:`kraken_tpu_torch.ops.transpose_ref.transpose_only_ref`); a CUDA
tensor launches the kernel or raises. The kernels live in the port's one
kernel library, built at first use (:mod:`kraken_tpu_torch.ops.cuda_lib`).

Unlike the TPU kernel, which folds only the first ``(P // 512) * 512``
bytes of a piece (its grid has ``nb // 8`` steps) and whose reshape needs
exactly 1024 rows, the wrappers take any whole number of 1024-row tiles
and raise for a P that is not a multiple of 512.

``LAUNCHES["transpose_only"]`` and ``LAUNCHES["natural_loads_only"]``
count each kernel's launches.
"""

from __future__ import annotations

import threading

import torch

from kraken_tpu_torch.ops import cuda_lib
from kraken_tpu_torch.ops.sha256_ref import N_TILE
from kraken_tpu_torch.ops.transpose_ref import PIECE_ALIGN, transpose_only_ref

LAUNCHES = {"transpose_only": 0, "natural_loads_only": 0}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _fold(rows: torch.Tensor, name: str, entry: str) -> torch.Tensor:
    """Check ``rows``, then the plain version on the CPU or ``entry`` on
    the card, counted under ``name``."""
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes cpu or cuda tensors, got {rows.device}")
    if rows.dim() != 2 or rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D uint8 tensor")
    m, p = rows.shape
    if m == 0 or m % N_TILE or p == 0 or p % PIECE_ALIGN:
        raise ValueError(
            f"{name} needs M a positive multiple of {N_TILE} and P a "
            f"positive multiple of {PIECE_ALIGN}: got [{m}, {p}]"
        )
    if rows.device.type == "cpu":
        return transpose_only_ref(rows)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned")
    out = torch.empty((m // N_TILE, 8, 8, 128), dtype=torch.int32, device=rows.device)
    cuda_lib.launch(entry, rows.device, rows.data_ptr(), m, p, out.data_ptr())
    with _lock:
        LAUNCHES[name] += 1
    return out


def transpose_only(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` ([M, P] uint8, contiguous, M a positive multiple of 1024, P
    a positive multiple of 512) -> [M / 1024, 8, 8, 128] int32 folded
    words (uint32 bit patterns), by the fold that fills the card."""
    return _fold(rows, "transpose_only", "transpose_only_launch")


def natural_loads_only(rows: torch.Tensor) -> torch.Tensor:
    """The same function as :func:`transpose_only`, through the natural
    SHA-256 kernel's loads (the decomposition's loads leg)."""
    return _fold(rows, "natural_loads_only", "natural_loads_launch")
