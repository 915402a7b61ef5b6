"""Wrapper of the hand-written FastCDC gear kernel (``csrc/gear.cu``).

:func:`gear_mask` launches the kernel ``gear_mask_kernel``, the counterpart
of ``kraken_tpu/ops/cdc_pallas.py:81`` ``_gear_pallas``: for one window of
a blob, the 32-byte windowed gear hash at every position and its strict and
loose mask tests, as one byte a position (bit 0 strict, bit 1 loose).
:func:`candidate_indices` is the counterpart of ``cdc_pallas.py:116``
``candidate_indices_pallas``: it stages the blob through pinned host memory
in windows of ``WINDOW_BYTES`` with a 31-byte lead (the last real bytes
before the window; none before the blob's offset 0), makes one launch per
window, keeps the masks on the card, compacts them there with
``torch.nonzero``, and brings back only the candidate positions. What
bounds the kernel, and what its design does about it, is noted at the top
of its source.

A tensor on the CPU goes through the plain PyTorch version
(:func:`kraken_tpu_torch.ops.cdc_ref.gear_mask_ref`); a CUDA tensor
launches the kernel or raises. The kernel lives in the port's one kernel
library, built at first use (:mod:`kraken_tpu_torch.ops.cuda_lib`).

``LAUNCHES["gear_candidates"]`` counts the kernel's launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from kraken_tpu_torch.ops import cuda_lib
from kraken_tpu_torch.ops.cdc import _WINDOW, CDCParams
from kraken_tpu_torch.ops.cdc_ref import gear_mask_ref

# Data bytes a launch: the TPU's dispatch (cdc_pallas.py: 256 segments of
# 256 KiB). Large enough that a launch fills the card many times over,
# small enough that the staging buffer and the mask stay O(window).
WINDOW_BYTES = 64 << 20
TILE = 4096  # positions a block of csrc/gear.cu (kTile)
LEAD = 32  # buffer bytes before a window's first position (kLead)

LAUNCHES = {"gear_candidates": 0}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        LAUNCHES["gear_candidates"] = 0


def padded(n: int) -> int:
    """Positions the kernel computes for an ``n``-position window: whole
    tiles. The staging buffer holds ``LEAD + padded(n)`` bytes."""
    return -(-n // TILE) * TILE


def gear_mask(
    buf: torch.Tensor, n: int, hist: int, mask_s: int, mask_l: int
) -> torch.Tensor:
    """The gear pass over one window: ``buf[LEAD + p]`` is byte p of the
    window (p < n), ``buf[LEAD - hist : LEAD]`` the real bytes before it
    (0 <= hist <= 31), earlier bytes count as zero gear values. ``buf`` is
    a contiguous 1-D uint8 tensor of at least ``LEAD + padded(n)`` bytes.
    Returns [n] uint8: bit 0 strict, bit 1 loose."""
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gear pass takes cpu or cuda tensors, got {buf.device}")
    if buf.dim() != 1 or buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D uint8 tensor")
    if n < 0 or buf.numel() < LEAD + padded(n):
        raise ValueError(f"buf holds {buf.numel()} bytes, a window of {n} needs {LEAD + padded(n)}")
    if not 0 <= hist < _WINDOW:
        raise ValueError(f"hist must be in [0, {_WINDOW}): {hist}")
    if buf.device.type == "cpu":
        return gear_mask_ref(buf, n, hist, mask_s, mask_l, LEAD)
    if buf.data_ptr() % 16:
        raise ValueError("buf must start 16-byte aligned")
    out = torch.empty(padded(n), dtype=torch.uint8, device=buf.device)
    if n:
        cuda_lib.launch(
            "gear_mask_launch", buf.device, buf.data_ptr(), n, hist,
            mask_s, mask_l, out.data_ptr(),
        )
        with _lock:
            LAUNCHES["gear_candidates"] += 1
    return out[:n]


def candidate_indices(
    arr: np.ndarray, n: int, params: CDCParams, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """Global sorted strict and loose candidate positions over ``arr[:n]``
    (int64), zero history before offset 0, through :func:`gear_mask` on
    ``device``."""
    pinned = device.type == "cuda"
    strict_parts = [np.empty(0, dtype=np.int64)]
    loose_parts = [np.empty(0, dtype=np.int64)]
    for s in range(0, n, WINDOW_BYTES):
        m = min(WINDOW_BYTES, n - s)
        hist = min(s, _WINDOW - 1)
        host = torch.empty(LEAD + padded(m), dtype=torch.uint8, pin_memory=pinned)
        host.numpy()[LEAD - hist : LEAD + m] = arr[s - hist : s + m]
        mask = gear_mask(
            host.to(device, non_blocking=True), m, hist,
            params.mask_strict, params.mask_loose,
        )
        idx = torch.nonzero(mask).squeeze(1)
        kind = mask[idx]
        strict_parts.append(idx[(kind & 1) != 0].cpu().numpy() + s)
        loose_parts.append(idx[(kind & 2) != 0].cpu().numpy() + s)
    return np.concatenate(strict_parts), np.concatenate(loose_parts)
