"""The plain PyTorch gear pass -- the reference ``csrc/gear.cu`` is held to.

Computes what ``kraken_tpu/ops/cdc.py`` ``_gear_candidates`` computes: the
32-byte windowed gear hash ``h_i = sum_{j<32} gear(b_{i-j}) << j (mod 2^32)``
at every position, by the same five log-doubling steps, with zero history
in the gear domain before offset 0, and the strict and loose mask tests.
:func:`gear_candidates_window_ref` computes what the kernel's wrapper
returns for one window, in its buffer layout
(:mod:`kraken_tpu_torch.ops.cdc_cuda`). The CPU route of the wrapper runs
it; on the card it exists to be compared with the kernel.

Words are carried in ``int64`` masked to 32 bits: PyTorch's ``uint32`` has
no shifts or additions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from kraken_tpu_torch.ops.cdc import _GEAR_C1, _GEAR_C2, _WINDOW, split_codes

MASK = 0xFFFFFFFF


def gear_ref(data: torch.Tensor) -> torch.Tensor:
    """The arithmetic gear of each byte (uint8 -> int64 in [0, 2^32)). The
    second multiply is split into 16-bit halves of the constant, so every
    product stays below 2^48."""
    x = ((data.long() + 1) * _GEAR_C1) & MASK
    x ^= x >> 15
    x = ((x * (_GEAR_C2 & 0xFFFF)) + (((x * (_GEAR_C2 >> 16)) & 0xFFFF) << 16)) & MASK
    return x ^ (x >> 13)


def gear_hashes_ref(data: torch.Tensor) -> torch.Tensor:
    """[L] uint8 -> [L] int64: the windowed gear hash ending at each
    position, zero gear values before position 0. Log-doubling: after step
    k each position holds its last-2^k-term partial sum, and
    ``H_{k+1}[i] = H_k[i] + (H_k[i - 2^k] << 2^k)``."""
    h = gear_ref(data)
    step = 1
    while step < _WINDOW:
        shifted = torch.cat([h.new_zeros(min(step, h.numel())), h[:-step]])
        h = (h + (shifted << step)) & MASK
        step *= 2
    return h


def gear_candidates_ref(
    data: torch.Tensor, mask_s: int, mask_l: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """[L] uint8 -> (strict, loose) [L] bool: whether the hash of the
    window ending at each position hits each mask."""
    h = gear_hashes_ref(data)
    return (h & mask_s) == 0, (h & mask_l) == 0


def gear_candidates_window_ref(
    buf: torch.Tensor, n: int, hist: int, mask_s: int, mask_l: int, lead: int
) -> tuple[np.ndarray, np.ndarray]:
    """What ``csrc/gear.cu``'s wrapper returns for one window: ``buf[lead +
    p]`` is byte p of the window (p < n), ``buf[lead - hist : lead]`` its
    real history. Returns the sorted window-relative strict and loose
    candidate positions (int64), through the same codes as the kernel's."""
    strict, loose = gear_candidates_ref(buf[lead - hist : lead + n], mask_s, mask_l)
    strict, loose = strict[hist:], loose[hist:]
    pos = torch.nonzero(strict | loose).squeeze(1)
    codes = (pos << 2) | strict[pos].long() | (loose[pos].long() << 1)
    return split_codes(codes.cpu().numpy())
