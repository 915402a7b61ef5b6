"""The plain PyTorch relayout diagnostic -- the reference the CUDA kernel of
``csrc/transpose.cu`` is held to.

:func:`transpose_only_ref` computes what ``bench_transpose.py``'s
``transpose_only`` computes on the TPU: for each piece of ``[M, P]`` uint8
rows, the XOR of its big-endian 32-bit words by word index mod 8 (every
32-byte line folded into one), as ``[M / 1024, 8, 8, 128]`` words, word i of
piece ``t * 1024 + s * 128 + l`` at ``[t, i, s, l]``. The CPU path of
:func:`kraken_tpu_torch.ops.transpose_cuda.transpose_only` runs it; on the
card it exists to be compared with the kernel.

It needs neither shifts nor ``uint32`` (which PyTorch lacks on the CPU):
XOR commutes with the byte swap, so the lines are XOR-folded as int64
while still in memory order, and the one remaining line is byte-swapped by
flipping each word's four bytes. Every fold halves the tensor, so it needs
no more memory than its input.
"""

from __future__ import annotations

import torch

from kraken_tpu_torch.ops.sha256_ref import N_TILE

_SUB, _LANES = 8, 128  # N_TILE = _SUB * _LANES: the TPU's (8, 128) tile
PIECE_ALIGN = 512  # bytes of one grid step of the TPU kernel (_KB * 64)


def transpose_only_ref(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` ([M, P] uint8, contiguous, M % 1024 == 0, P % 512 == 0) ->
    [M / 1024, 8, 8, 128] int32 folded words (uint32 bit patterns)."""
    m, p = rows.shape
    x = rows.view(torch.int64).view(m, p // 32, 4)  # [M, lines, 4 x 8 bytes]
    while x.shape[1] > 1:
        n = x.shape[1]
        h = n // 2
        y = x[:, :h] ^ x[:, h : 2 * h]
        if n % 2:
            y[:, 0] ^= x[:, 2 * h]
        x = y
    words = x.view(torch.uint8).view(m, 8, 4).flip(-1).contiguous().view(torch.int32)
    return words.view(m // N_TILE, _SUB, _LANES, 8).permute(0, 3, 1, 2).contiguous()
