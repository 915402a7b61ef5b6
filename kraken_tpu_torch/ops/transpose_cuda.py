"""Wrapper of the hand-written relayout diagnostic (``csrc/transpose.cu``).

:func:`transpose_only` launches the kernel ``transpose_only_kernel``, the
counterpart of ``bench_transpose.py:80`` ``transpose_only``: for each piece
of ``[M, P]`` uint8 rows, the XOR of its big-endian words by word index
mod 8, as ``[M / 1024, 8, 8, 128]`` words. It does the natural SHA-256
kernel's loads and byte swaps with no rounds, so that
:mod:`kraken_tpu_torch.bench.transpose` can split that kernel's time into
loads and rounds. It is on no path of the system.

What bounds it: bytes -- P read and 32 written per piece, two integer
operations a word. What the design does: it keeps the natural kernel's
access pattern on purpose (one thread per piece, 128 threads a block, the
same four 16-byte loads per 64-byte block through the shared
``load_block_aligned``, the block loop rolled), so its time is the natural
kernel's load cost and not that of a better fold; the full note is at the
top of its source.

A tensor on the CPU goes through the plain PyTorch version
(:func:`kraken_tpu_torch.ops.transpose_ref.transpose_only_ref`); a CUDA
tensor launches the kernel or raises. The kernel lives in the port's one
kernel library, built at first use (:mod:`kraken_tpu_torch.ops.cuda_lib`).

Unlike the TPU kernel, which folds only the first ``(P // 512) * 512``
bytes of a piece (its grid has ``nb // 8`` steps) and whose reshape needs
exactly 1024 rows, the wrapper takes any whole number of 1024-row tiles
and raises for a P that is not a multiple of 512.

``LAUNCHES["transpose_only"]`` counts the kernel's launches.
"""

from __future__ import annotations

import threading

import torch

from kraken_tpu_torch.ops import cuda_lib
from kraken_tpu_torch.ops.sha256_ref import N_TILE
from kraken_tpu_torch.ops.transpose_ref import PIECE_ALIGN, transpose_only_ref

LAUNCHES = {"transpose_only": 0}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        LAUNCHES["transpose_only"] = 0


def transpose_only(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` ([M, P] uint8, contiguous, M a positive multiple of 1024, P
    a positive multiple of 512) -> [M / 1024, 8, 8, 128] int32 folded
    words (uint32 bit patterns)."""
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"transpose_only takes cpu or cuda tensors, got {rows.device}")
    if rows.dim() != 2 or rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 2-D uint8 tensor")
    m, p = rows.shape
    if m == 0 or m % N_TILE or p == 0 or p % PIECE_ALIGN:
        raise ValueError(
            f"transpose_only needs M a positive multiple of {N_TILE} and P a "
            f"positive multiple of {PIECE_ALIGN}: got [{m}, {p}]"
        )
    if rows.device.type == "cpu":
        return transpose_only_ref(rows)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned")
    out = torch.empty((m // N_TILE, 8, 8, 128), dtype=torch.int32, device=rows.device)
    cuda_lib.launch("transpose_only_launch", rows.device, rows.data_ptr(), m, p, out.data_ptr())
    with _lock:
        LAUNCHES["transpose_only"] += 1
    return out
