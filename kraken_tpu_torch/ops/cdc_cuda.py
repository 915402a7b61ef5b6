"""Wrapper of the hand-written FastCDC gear kernel (``csrc/gear.cu``).

:func:`launch` launches the kernel ``gear_candidates_kernel``, the
counterpart of ``kraken_tpu/ops/cdc_pallas.py:81`` ``_gear_pallas`` and of
the compaction in its caller: for one window of a blob, the 32-byte
windowed gear hash at every position and its strict and loose mask tests,
written as compacted candidate codes ``pos << 2 | kind`` (bit 0 strict,
bit 1 loose) and their count, not as mask planes. :func:`gear_candidates`
returns one window's sorted candidates. :func:`candidate_indices` is the
counterpart of ``cdc_pallas.py:116`` ``candidate_indices_pallas``: it
stages the blob in windows of ``WINDOW_BYTES`` with a 31-byte lead (the
last real bytes before the window; none before the blob's offset 0) and
makes one launch a window. On the card, windows alternate between two
slots, each a pinned staging buffer, a device copy and code buffer, a
pinned readback and a stream of its own, allocated once a device and
reused: window k+1's host copy runs while window k transfers and hashes,
and each window's count and first ``READBACK_CODES`` codes come back
behind an event that is waited on only when the slot comes round again.
What bounds the kernel, and what its design does about it, is noted at the
top of its source.

The kernel tests each mask with one compare, so it takes only top-bit
masks with the strict one's bits containing the loose one's
(:func:`kraken_tpu_torch.ops.cdc.check_masks`, as ``CDCParams`` makes
them); other masks raise ``ValueError``.

A tensor on the CPU goes through the plain PyTorch version
(:func:`kraken_tpu_torch.ops.cdc_ref.gear_candidates_window_ref`), and
:func:`candidate_indices` on a CPU device runs the same window loop through
it, with no streams and no pinning; a CUDA tensor launches the kernel or
raises. The kernel lives in the port's one kernel library, built at first
use (:mod:`kraken_tpu_torch.ops.cuda_lib`).

``LAUNCHES["gear_candidates"]`` counts the kernel's launches, so a run can
show that its main path went through the kernel. ``STAGES`` sums the card
route's seconds by stage over windows: ``host_copy`` (into pinned staging,
host clock), ``transfer``, ``kernel`` and ``readback`` (CUDA events on the
window's stream), ``wait`` (host blocked on a window's last event) and
``sort`` (the codes split on the host).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kraken_tpu_torch.ops import cuda_lib
from kraken_tpu_torch.ops.cdc import _WINDOW, CDCParams, check_masks, split_codes
from kraken_tpu_torch.ops.cdc_ref import gear_candidates_window_ref

# Data bytes a launch: the TPU's dispatch (cdc_pallas.py: 256 segments of
# 256 KiB). Large enough that a launch fills the card many times over,
# small enough that the staging and code buffers stay O(window).
WINDOW_BYTES = 64 << 20
STEP = 1024  # positions a warp a step of csrc/gear.cu (kStep): the padding granule
LEAD = 32  # buffer bytes before a window's first position (kLead)
MAX_WINDOW = 1 << 29  # a window-relative code pos << 2 | kind fits an int32
# Codes a window brings back with its count behind its event; a window with
# more (~16 x the default parameters' ~4,096 a 64 MiB window) reads the
# rest once its event has passed.
READBACK_CODES = 1 << 16
# Threads of the copy into pinned staging (np.copyto releases the GIL).
COPY_THREADS = 4

LAUNCHES = {"gear_candidates": 0}
STAGES = dict.fromkeys(("host_copy", "transfer", "kernel", "readback", "wait", "sort"), 0.0)
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        LAUNCHES["gear_candidates"] = 0


def reset_stages() -> None:
    with _lock:
        for k in STAGES:
            STAGES[k] = 0.0


def padded(n: int) -> int:
    """Positions the kernel hashes for an ``n``-position window: whole warp
    steps. A window's buffer holds ``LEAD + padded(n)`` bytes."""
    return -(-n // STEP) * STEP


def _check(buf: torch.Tensor, n: int, hist: int, mask_s: int, mask_l: int) -> None:
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gear pass takes cpu or cuda tensors, got {buf.device}")
    if buf.dim() != 1 or buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D uint8 tensor")
    if not 0 <= n < MAX_WINDOW:
        raise ValueError(f"a window holds 0 to {MAX_WINDOW - 1} positions: {n}")
    if buf.numel() < LEAD + padded(n):
        raise ValueError(f"buf holds {buf.numel()} bytes, a window of {n} needs {LEAD + padded(n)}")
    if not 0 <= hist < _WINDOW:
        raise ValueError(f"hist must be in [0, {_WINDOW}): {hist}")
    check_masks(mask_s, mask_l)


def launch(
    buf: torch.Tensor, n: int, hist: int, mask_s: int, mask_l: int, out: torch.Tensor
) -> None:
    """Launch the kernel on the current stream over one window:
    ``buf[LEAD + p]`` is byte p of the window (p < n), ``buf[LEAD - hist :
    LEAD]`` the real bytes before it (0 <= hist <= 31), earlier bytes count
    as zero gear values; ``buf`` is a contiguous 1-D uint8 CUDA tensor of
    at least ``LEAD + padded(n)`` bytes, 16-byte aligned. Writes the count
    of candidates to ``out[0]`` and their codes, in no order, to
    ``out[1 : 1 + count]`` (``out``: int32, ``n + 1`` slots or more)."""
    _check(buf, n, hist, mask_s, mask_l)
    if buf.device.type != "cuda":
        raise ValueError(f"the gear kernel runs on cuda tensors, got {buf.device}")
    if buf.data_ptr() % 16:
        raise ValueError("buf must start 16-byte aligned")
    if (out.device != buf.device or out.dtype != torch.int32 or not out.is_contiguous()
            or out.numel() < n + 1):
        raise ValueError(f"out must be a contiguous int32 tensor of {n + 1} slots on {buf.device}")
    cuda_lib.launch(
        "gear_candidates_launch", buf.device, buf.data_ptr(), n, hist,
        mask_s, mask_l, out.data_ptr(),
    )
    if n:
        with _lock:
            LAUNCHES["gear_candidates"] += 1


def gear_candidates(
    buf: torch.Tensor, n: int, hist: int, mask_s: int, mask_l: int
) -> tuple[np.ndarray, np.ndarray]:
    """The gear pass over one window (layout of :func:`launch`; any
    alignment on the CPU): the sorted window-relative strict and loose
    candidate positions (int64)."""
    if buf.device.type == "cpu":
        _check(buf, n, hist, mask_s, mask_l)
        return gear_candidates_window_ref(buf, n, hist, mask_s, mask_l, LEAD)
    out = torch.empty(n + 1, dtype=torch.int32, device=buf.device)
    launch(buf, n, hist, mask_s, mask_l, out)
    count = int(out[0])
    return split_codes(out[1 : 1 + count].cpu().numpy())


def _windows(n: int):
    """(start, positions, bytes of history) of each window of ``arr[:n]``."""
    for s in range(0, n, WINDOW_BYTES):
        yield s, min(WINDOW_BYTES, n - s), min(s, _WINDOW - 1)


_pool: ThreadPoolExecutor | None = None


def _copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[:] = src``, split over ``COPY_THREADS`` threads."""
    global _pool
    step = -(-src.size // COPY_THREADS)
    if COPY_THREADS <= 1 or step < 1 << 20:
        np.copyto(dst, src)
        return
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="cdc-copy")
    list(_pool.map(lambda a: np.copyto(dst[a : a + step], src[a : a + step]),
                   range(0, src.size, step)))


class _Slot:
    """One window's reused buffers on one card: pinned staging, the device
    copy and code buffer (allocated on the slot's stream, the only one
    that touches them), the pinned readback, and the events of the window
    in flight (before the transfer, before and after the kernel, after the
    readback)."""

    def __init__(self, device: torch.device, window: int):
        self.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self.stream):
            self.buf = torch.empty(LEAD + padded(window), dtype=torch.uint8, device=device)
            self.out = torch.empty(window + 1, dtype=torch.int32, device=device)
        self.host = torch.empty(LEAD + padded(window), dtype=torch.uint8, pin_memory=True)
        self.back = torch.empty(1 + READBACK_CODES, dtype=torch.int32, pin_memory=True)
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        self.pending: int | None = None  # start of the window in flight

    def start(self, arr: np.ndarray, s: int, m: int, hist: int, mask_s: int, mask_l: int):
        t0 = time.perf_counter()
        _copy(self.host.numpy()[LEAD - hist : LEAD + m], arr[s - hist : s + m])
        STAGES["host_copy"] += time.perf_counter() - t0
        size, k = LEAD + padded(m), 1 + min(m, READBACK_CODES)
        ev = self.events
        with torch.cuda.stream(self.stream):
            ev[0].record()
            self.buf[:size].copy_(self.host[:size], non_blocking=True)
            ev[1].record()
            launch(self.buf, m, hist, mask_s, mask_l, self.out)
            ev[2].record()
            self.back[:k].copy_(self.out[:k], non_blocking=True)
            ev[3].record()
        self.pending = s

    def finish(self) -> tuple[int, np.ndarray, np.ndarray]:
        """Wait for the window in flight; its start and sorted window-relative
        strict and loose positions."""
        ev = self.events
        t0 = time.perf_counter()
        ev[3].synchronize()
        t1 = time.perf_counter()
        count = int(self.back[0])
        codes = self.back.numpy()[1 : 1 + min(count, READBACK_CODES)].copy()
        if count > READBACK_CODES:
            with torch.cuda.stream(self.stream):
                rest = self.out[1 + READBACK_CODES : 1 + count].cpu().numpy()
            codes = np.concatenate([codes, rest])
        t2 = time.perf_counter()
        strict, loose = split_codes(codes)
        STAGES["wait"] += t1 - t0
        STAGES["sort"] += time.perf_counter() - t2
        STAGES["transfer"] += ev[0].elapsed_time(ev[1]) / 1e3
        STAGES["kernel"] += ev[1].elapsed_time(ev[2]) / 1e3
        STAGES["readback"] += ev[2].elapsed_time(ev[3]) / 1e3
        s, self.pending = self.pending, None
        return s, strict, loose


_slots: dict[tuple[int, int], tuple[threading.Lock, list[_Slot]]] = {}


def _device_slots(device: torch.device) -> tuple[threading.Lock, list[_Slot]]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, WINDOW_BYTES)
    with _lock:
        if key not in _slots:
            dev = torch.device("cuda", index)
            _slots[key] = (threading.Lock(), [_Slot(dev, WINDOW_BYTES) for _ in range(2)])
        return _slots[key]


def candidate_indices(
    arr: np.ndarray, n: int, params: CDCParams, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """Global sorted strict and loose candidate positions over ``arr[:n]``
    (int64), zero history before offset 0, one launch a window on
    ``device`` (the plain version on a CPU device)."""
    mask_s, mask_l = params.mask_strict, params.mask_loose
    check_masks(mask_s, mask_l)
    parts = []
    if device.type == "cuda":
        lock, slots = _device_slots(device)
        with lock:
            try:
                for k, (s, m, hist) in enumerate(_windows(n)):
                    slot = slots[k % 2]
                    if slot.pending is not None:
                        parts.append(slot.finish())
                    slot.start(arr, s, m, hist, mask_s, mask_l)
                parts += [slot.finish() for slot in slots if slot.pending is not None]
            except BaseException:
                # A failed call leaves no window in flight for the next one.
                for slot in slots:
                    slot.stream.synchronize()
                    slot.pending = None
                raise
    else:
        for s, m, hist in _windows(n):
            buf = torch.empty(LEAD + padded(m), dtype=torch.uint8)
            buf.numpy()[LEAD - hist : LEAD + m] = arr[s - hist : s + m]
            parts.append((s, *gear_candidates(buf, m, hist, mask_s, mask_l)))
    parts.sort(key=lambda part: part[0])
    empty = np.empty(0, dtype=np.int64)
    return (np.concatenate([empty] + [st + s for s, st, _ in parts]),
            np.concatenate([empty] + [lo + s for s, _, lo in parts]))
