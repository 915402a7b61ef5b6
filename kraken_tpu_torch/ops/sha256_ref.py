"""The plain PyTorch SHA-256 -- the reference the CUDA kernels are held to.

Computes what ``csrc/sha256.cu`` computes, ``sha256_rows(flat, offsets,
lengths) -> [N, 8]`` digest words, and what ``csrc/sha256_packed.cu``
computes (the relayout into the packed word-major layout,
:func:`pack_tiles_ref`, and the hash of packed words,
:func:`sha256_packed_ref`), with tensor ops only, on any device. The CPU
path of the wrappers in :mod:`kraken_tpu_torch.ops.sha256_cuda` runs it;
on the card it exists to be compared with the kernels.

Words are carried in ``int64`` masked to 32 bits: PyTorch's ``uint32`` has
no shifts or additions on the CPU. A rotation folds the word into both
halves of the int64 (``y = x | x << 32``) so that ``(y >> n) & MASK`` is
``rotr(x, n)`` for ``n < 32``.

Rows are sorted by block count and walked in chunks of ``_CHUNK`` blocks:
within a chunk the message schedule is computed for every block at once,
then the 64 rounds run block by block over the rows still active. Memory is
O(rows x chunk), whatever the longest row.
"""

from __future__ import annotations

import numpy as np
import torch

# fmt: off
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)
_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)
# fmt: on

MASK = 0xFFFFFFFF
_CHUNK = 64  # blocks per schedule pass


def nblocks_of(lengths: torch.Tensor) -> torch.Tensor:
    """SHA-256 block count of a message of each length: the data, one 0x80
    byte and the 8-byte bit length, rounded up to 64-byte blocks."""
    return (lengths + 8) // 64 + 1


def _sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """Message-schedule sigma: rotr(x, r1) ^ rotr(x, r2) ^ (x >> s)."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ (x >> s)) & MASK


def _big_sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """Round Sigma: rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3)."""
    y = x | (x << 32)
    return ((y >> r1) ^ (y >> r2) ^ (y >> r3)) & MASK


def _schedule(words: torch.Tensor) -> torch.Tensor:
    """[R, C, 16] message words -> [C, 64, R] of ``W[i] + K[i]`` for every
    block of every row (the schedule does not depend on the state)."""
    w = list(words.unbind(-1))
    for t in range(16, 64):
        w.append(
            (w[t - 16] + _sigma(w[t - 15], 7, 18, 3) + w[t - 7]
             + _sigma(w[t - 2], 17, 19, 10)) & MASK
        )
    k = torch.as_tensor(_K.astype(np.int64), device=words.device)
    kw = torch.stack(w, 0) + k[:, None, None]  # [64, R, C]
    return kw.permute(2, 0, 1).contiguous()


def compress(state: list[torch.Tensor], kw: torch.Tensor) -> list[torch.Tensor]:
    """One SHA-256 compression of a block per row. ``state``: 8 tensors
    [R]; ``kw``: [64, R] of ``W[i] + K[i]``. Returns the new 8 words."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        t1 = h + _big_sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + kw[i]
        t2 = _big_sigma(a, 2, 13, 22) + ((a & (b ^ c)) ^ (b & c))
        a, b, c, d, e, f, g, h = (
            (t1 + t2) & MASK, a, b, c, (d + t1) & MASK, e, f, g,
        )
    return [(s + v) & MASK for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _padded_words(
    flat: torch.Tensor, off: torch.Tensor, ln: torch.Tensor, b0: int, nb: int
) -> torch.Tensor:
    """Blocks ``[b0, b0 + nb)`` of each SHA-padded row as [R, nb, 16]
    big-endian words: the row's bytes, 0x80, zeros, then the 64-bit bit
    length at the end of its last block."""
    rel = b0 * 64 + torch.arange(nb * 64, device=flat.device)[None, :]
    ln = ln[:, None]
    src = (off[:, None] + rel).clamp(0, flat.numel() - 1)
    byte = torch.where(rel < ln, flat[src].long(), 0)
    byte = torch.where(rel == ln, 0x80, byte)
    k = rel - (nblocks_of(ln) * 64 - 8)  # position inside the length field
    in_len = (k >= 0) & (k < 8)
    len_byte = ((ln * 8) >> ((7 - k.clamp(0, 7)) * 8)) & 0xFF
    byte = torch.where(in_len, len_byte, byte).view(-1, nb, 16, 4)
    return (
        (byte[..., 0] << 24) | (byte[..., 1] << 16)
        | (byte[..., 2] << 8) | byte[..., 3]
    )


def sha256_rows_ref(
    flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """SHA-256 of each row ``flat[offsets[i] : offsets[i] + lengths[i]]``.

    ``flat``: 1-D uint8; ``offsets``, ``lengths``: 1-D int64 of N rows.
    Returns [N, 8] int32 digest words (the uint32 bit patterns)."""
    n = lengths.numel()
    dev = flat.device
    if flat.numel() == 0:
        flat = torch.zeros(1, dtype=torch.uint8, device=dev)
    nblocks = nblocks_of(lengths)
    order = torch.argsort(nblocks, descending=True)
    nb_s, off_s, ln_s = nblocks[order], offsets[order], lengths[order]
    state = torch.as_tensor(_H0.astype(np.int64), device=dev).repeat(n, 1)
    total = int(nb_s[0]) if n else 0
    for b0 in range(0, total, _CHUNK):
        m = int((nb_s > b0).sum())  # rows still hashing: a prefix
        nb = min(_CHUNK, total - b0)
        kw = _schedule(_padded_words(flat, off_s[:m], ln_s[:m], b0, nb))
        st = list(state[:m].unbind(1))
        for j in range(nb):
            new = compress(st, kw[j])
            keep = (b0 + j) < nb_s[:m]
            st = [torch.where(keep, v, s) for v, s in zip(new, st)]
        state[:m] = torch.stack(st, 1)
    out = torch.empty_like(state)
    out[order] = state
    return _to_int32(out)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 of the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def uniform_rows(rows: torch.Tensor):
    """``rows`` ([M, P] uint8, contiguous) as the (flat, offsets, lengths)
    of M rows of P bytes back to back."""
    m, p = rows.shape
    offsets = torch.arange(m, dtype=torch.int64, device=rows.device) * p
    lengths = torch.full((m,), p, dtype=torch.int64, device=rows.device)
    return rows.view(-1), offsets, lengths


def sha256_uniform_ref(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of ``rows`` ([M, P] uint8, contiguous): the
    uniform case of :func:`sha256_rows_ref`. Returns [M, 8] int32."""
    return sha256_rows_ref(*uniform_rows(rows))


# -- the packed layout (csrc/sha256_packed.cu) ---------------------------------
#
# ``[T, NB, 16, 8, 128]`` words, the layout of kraken_tpu's packed Pallas
# kernel and of both host packers (``[T, NB, 16, 1024]`` is the same
# memory): word j of block kb of piece ``t * 1024 + lane`` sits at
# ``[t, kb, j, lane // 128, lane % 128]``, big-endian, so no byte swap is
# left for the hash. NB is the block count rounded up to ``_KB``; blocks
# past the piece's own are zero and never hashed.

N_TILE = 1024  # pieces per packed tile
_KB = 8  # the packed block axis is a multiple of this


def packed_nb(unpadded_blocks: int) -> int:
    """Block-axis extent of the packed layout for a chain of
    ``unpadded_blocks`` 64-byte blocks."""
    return (unpadded_blocks + _KB - 1) // _KB * _KB


def pack_tiles_ref(rows: torch.Tensor, unpadded_blocks: int) -> torch.Tensor:
    """The relayout, plainly: [M, P] uint8 pieces (M % 1024 == 0, P =
    ``unpadded_blocks`` * 64, contiguous) -> [T, NB, 16, 8, 128] int32
    big-endian words, NB = ``packed_nb(unpadded_blocks)``, trailing blocks
    zero. Vectorized, a bounded slab of blocks per pass."""
    m, p = rows.shape
    nb, t = unpadded_blocks, m // N_TILE
    nbp = packed_nb(nb)
    out = torch.zeros((t, nbp, 16, N_TILE), dtype=torch.int32, device=rows.device)
    src = rows.view(t, N_TILE, nb, 16, 4)
    step = max(1, (1 << 26) // max(1, m * 64))  # ~64 MiB of bytes a pass
    for b0 in range(0, nb, step):
        b = src[:, :, b0 : b0 + step].long()  # [t, 1024, c, 16, 4]
        w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
        out[:, b0 : b0 + b.shape[2]] = _to_int32(w).permute(0, 2, 3, 1)
    return out.view(t, nbp, 16, 8, 128)


def _pad_block(nbytes: int, device) -> torch.Tensor:
    """The SHA-256 padding block of a message of ``nbytes`` bytes, a
    multiple of 64: 0x80, zeros, the 64-bit bit length. [1, 1, 16]."""
    bits = nbytes * 8
    w = [0x80000000] + [0] * 13 + [bits >> 32, bits & MASK]
    return torch.tensor(w, dtype=torch.int64, device=device).view(1, 1, 16)


def sha256_packed_ref(packed: torch.Tensor, unpadded_blocks: int) -> torch.Tensor:
    """The packed hash, plainly: SHA-256 of the ``T * 1024`` pieces of
    ``unpadded_blocks`` blocks each in ``packed`` ([T, NB, 16, 8, 128]
    int32 big-endian words, NB >= unpadded_blocks), the padding block
    folded after the last data block. Returns [T * 1024, 8] int32 digest
    words in piece order."""
    t, nbp = packed.shape[:2]
    nb, n = unpadded_blocks, t * N_TILE
    words = packed.reshape(t, nbp, 16, N_TILE)
    st = list(
        torch.as_tensor(_H0.astype(np.int64), device=packed.device)
        .repeat(n, 1).unbind(1)
    )
    for b0 in range(0, nb, _CHUNK):
        c = min(_CHUNK, nb - b0)
        w = words[:, b0 : b0 + c].long() & MASK  # [t, c, 16, 1024]
        kw = _schedule(w.permute(0, 3, 1, 2).reshape(n, c, 16))
        for j in range(c):
            st = compress(st, kw[j])
    st = compress(st, _schedule(_pad_block(nb * 64, packed.device))[0])
    return _to_int32(torch.stack(st, 1))
