"""FastCDC content-defined chunking with the rolling-hash pass on the card.

The counterpart of ``kraken_tpu/ops/cdc.py``. Docker layers are chunked on
content-defined boundaries, so identical file content shifted by tar
offsets still dedupes across layers (BASELINE.json config 4).

Algorithm (the normative spec; the pure-Python :func:`chunk_reference`
below is the golden oracle for tests):

- 32-bit gear rolling hash: ``h_i = (h_{i-1} << 1) + GEAR[b_i]  (mod 2^32)``.
  Because of the shift, ``h_i`` depends only on the last 32 bytes, so every
  position's hash is a *windowed* function and all positions evaluate in
  parallel.
- FastCDC normalized chunking: below the average chunk size a *strict* mask
  must hit (fewer cuts), above it a *loose* mask (more cuts); hard
  ``min_size``/``max_size`` bounds. Masks are contiguous high bits of the
  32-bit hash.

Two phases: the card computes the rolling hash and both mask tests for
*every* offset (``csrc/gear.cu``, through
:func:`kraken_tpu_torch.ops.cdc_cuda.candidate_indices`) and sends back only
the candidate positions; the host walks them applying the sequential
min/avg/max cut policy (:func:`_host_select_cuts`). The phases compose to
exactly the sequential algorithm because the cut policy never looks at
hashes, only at candidate positions.

Chunk boundaries are an on-disk contract (dedup sidecars, chunk recipes):
the gear function, the masks and the policy are the JAX package's, bit for
bit.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from kraken_tpu_torch.ops import resolve_device

_WINDOW = 32  # bytes of history in a 32-bit gear hash

# Deterministic gear function: framework constant, must never change (chunk
# boundaries are a persistent on-disk contract once dedup metadata is
# written). Defined ARITHMETICALLY (murmur-style avalanche of the byte)
# rather than as a lookup table: TPUs have no fast arbitrary gather -- a
# 256-entry table lookup ran the device pass at ~0.1 GB/s, while the same
# dispersion as 6 vector ops runs at memory speed. The table form below is
# derived from the function and is only used by host-side code.
_GEAR_C1 = 0x9E3779B1  # golden-ratio odd constant
_GEAR_C2 = 0x85EBCA77  # murmur3-style mixer


def _gear_fn_py(b: int) -> int:
    """Reference arithmetic gear: byte -> well-dispersed uint32."""
    x = ((b + 1) * _GEAR_C1) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * _GEAR_C2) & 0xFFFFFFFF
    x ^= x >> 13
    return x


GEAR = np.array([_gear_fn_py(i) for i in range(256)], dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class CDCParams:
    """Chunking parameters. ``avg_size`` must be a power of two."""

    min_size: int = 16 * 1024
    avg_size: int = 64 * 1024
    max_size: int = 256 * 1024
    # Normalization level: strict mask has (log2(avg) + nc) bits, loose has
    # (log2(avg) - nc). nc=2 per the FastCDC paper's recommendation.
    norm: int = 2

    def __post_init__(self):
        if self.avg_size & (self.avg_size - 1):
            raise ValueError(f"avg_size must be a power of two: {self.avg_size}")
        if not self.min_size <= self.avg_size <= self.max_size:
            raise ValueError("require min_size <= avg_size <= max_size")
        if self.min_size < _WINDOW:
            # Below this the vectorized pass (full 32-byte history at every
            # offset) and the sequential reference (hash restarts per chunk)
            # could disagree near chunk starts.
            raise ValueError(f"min_size must be >= {_WINDOW}: {self.min_size}")

    @property
    def bits(self) -> int:
        return self.avg_size.bit_length() - 1

    @property
    def mask_strict(self) -> int:
        return _top_mask(self.bits + self.norm)

    @property
    def mask_loose(self) -> int:
        return _top_mask(self.bits - self.norm)


def _top_mask(nbits: int) -> int:
    """A mask of ``nbits`` high bits of a uint32."""
    nbits = max(0, min(32, nbits))
    return ((1 << nbits) - 1) << (32 - nbits) & 0xFFFFFFFF


def check_masks(mask_s: int, mask_l: int) -> None:
    """Refuse masks the gear kernel cannot test in one compare: each must be
    a top-bit mask (:func:`_top_mask`, ``0`` included) and the strict one's
    bits must contain the loose one's, as :class:`CDCParams` makes them."""
    for name, mask in (("mask_s", mask_s), ("mask_l", mask_l)):
        low = (1 << 32) - mask
        if not 0 <= mask < 1 << 32 or low & (low - 1):
            raise ValueError(f"{name} must be a mask of high bits of a uint32: {mask:#x}")
    if mask_s & mask_l != mask_l:
        raise ValueError(f"mask_s {mask_s:#x} must contain mask_l {mask_l:#x}")


def split_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Candidate codes ``pos << 2 | kind`` (bit 0 strict, bit 1 loose), in
    any order -> the sorted strict and loose positions (int64)."""
    codes = np.sort(np.asarray(codes, dtype=np.int64))
    pos = codes >> 2
    return pos[(codes & 1) != 0], pos[(codes & 2) != 0]


# -- pure-Python reference (golden oracle; O(n) python -- tests only) -------


def chunk_reference(data: bytes, params: CDCParams = CDCParams()) -> list[int]:
    """Sequential FastCDC. Returns chunk end offsets (exclusive)."""
    cuts = []
    n = len(data)
    start = 0
    while start < n:
        end = _next_cut_reference(data, start, n, params)
        cuts.append(end)
        start = end
    return cuts


def _next_cut_reference(data: bytes, start: int, n: int, p: CDCParams) -> int:
    remaining = n - start
    if remaining <= p.min_size:
        return n
    h = 0
    limit = min(remaining, p.max_size)
    norm_point = min(p.avg_size, limit)
    # Hash accumulates from the chunk start (matching the vector pass, which
    # has full history; the first min_size bytes are hashed but uncuttable).
    for i in range(limit):
        h = ((h << 1) + int(GEAR[data[start + i]])) & 0xFFFFFFFF
        if i + 1 <= p.min_size:
            continue
        mask = p.mask_strict if i + 1 <= norm_point else p.mask_loose
        if (h & mask) == 0:
            return start + i + 1
    return start + limit


# -- host cut policy --------------------------------------------------------


def _host_select_cuts(
    strict_idx: np.ndarray, loose_idx: np.ndarray, n: int, p: CDCParams
) -> list[int]:
    """Sequential cut selection over sparse candidate positions.

    ``strict_idx``/``loose_idx`` hold positions i where the mask hit; a cut
    at position i ends a chunk at offset i+1. Equivalence with the
    sequential reference holds because candidates are only taken at offsets
    > min_size >= _WINDOW past the chunk start, where the 32-byte gear
    window lies entirely inside the current chunk -- so the full-history
    hash of the vector pass equals the restarted hash of the reference.
    The walk bisects Python lists: a scalar ``np.searchsorted`` costs
    microseconds a call, and the walk makes two to four calls a chunk.
    """
    strict, loose = np.asarray(strict_idx).tolist(), np.asarray(loose_idx).tolist()
    cuts: list[int] = []
    start = 0
    while start < n:
        remaining = n - start
        if remaining <= p.min_size:
            cuts.append(n)
            break
        limit = min(remaining, p.max_size)
        norm_point = min(p.avg_size, limit)
        # strict zone: offsets (start+min_size, start+norm_point]
        lo = bisect.bisect_left(strict, start + p.min_size)
        hi = bisect.bisect_right(strict, start + norm_point - 1)
        if lo < hi:
            end = strict[lo] + 1
        else:
            # loose zone: offsets (start+norm_point, start+limit]
            lo = bisect.bisect_left(loose, start + norm_point)
            hi = bisect.bisect_right(loose, start + limit - 1)
            end = loose[lo] + 1 if lo < hi else start + limit
        cuts.append(end)
        start = end
    return cuts


def spans_from_cuts(cuts) -> list[tuple[int, int]]:
    """Cut end-offsets (exclusive, ascending) -> (start, end) spans."""
    spans = []
    start = 0
    for end in cuts:
        spans.append((start, int(end)))
        start = int(end)
    return spans


# -- the device pass ----------------------------------------------------------


def chunk(
    data: bytes | memoryview,
    params: CDCParams = CDCParams(),
    device: str | torch.device | None = None,
) -> list[int]:
    """Content-defined chunk boundaries (end offsets, exclusive).

    The gear pass runs on ``device`` (``None``: the card; ``"cpu"``: its
    plain PyTorch version) window by window, with O(window) memory for any
    blob size; the host applies the cut policy. Exactly equal to
    :func:`chunk_reference`.
    """
    from kraken_tpu_torch.ops.cdc_cuda import candidate_indices

    dev = resolve_device(device, "the gear pass")
    view = memoryview(data)
    n = len(view)
    if n == 0:
        return []
    arr = np.frombuffer(view, dtype=np.uint8)
    strict_idx, loose_idx = candidate_indices(arr, n, params, dev)
    return _host_select_cuts(strict_idx, loose_idx, n, params)


def chunk_spans(
    data: bytes | memoryview,
    params: CDCParams = CDCParams(),
    device: str | torch.device | None = None,
) -> list[tuple[int, int]]:
    """(start, end) spans for each chunk."""
    return spans_from_cuts(chunk(data, params, device))


def chunk_host(
    data: bytes | memoryview | np.ndarray, params: CDCParams = CDCParams()
) -> np.ndarray:
    """Host-plane chunker: cut end-offsets (uint64) WITHOUT touching the
    card, through the sequential C chunker of :mod:`kraken_tpu_torch.native`.
    A host with no C compiler runs the plain gear pass on the CPU instead.
    Both are bit-identical to :func:`chunk_reference`."""
    from kraken_tpu_torch.native import cdc_chunk_native

    arr = np.frombuffer(memoryview(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data
    if arr.size == 0:
        return np.empty(0, dtype=np.uint64)
    cuts = cdc_chunk_native(
        arr, params.min_size, params.avg_size, params.max_size,
        params.mask_strict, params.mask_loose,
    )
    if cuts is not None:
        return cuts
    return np.asarray(chunk(arr, params, device="cpu"), dtype=np.uint64)
