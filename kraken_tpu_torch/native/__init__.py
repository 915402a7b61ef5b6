"""Native host-side components (C, built on first use, ctypes-bound).

The port's copy of ``kraken_tpu.native``: the card does the hashing and
the host's hot job is FEEDING it. ``hostpack.c`` (a copy of the JAX
package's source) packs natural piece bytes into the word-major tiles the
packed SHA-256 kernel reads (``pack_mode: native`` of the ingest plane),
and holds the sequential FastCDC chunker. Plain ctypes over a cc-compiled
shared object, with a NumPy fallback when no C compiler is available.

The library is built at first use into
``kraken_tpu_torch/_build/<hash of the source, compiler and flags>/``
(never beside the source), through a temp file and an atomic rename, so
concurrent builders never load a half-written object. ``packer()`` says
which packer runs: ``"c"`` or ``"numpy"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostpack.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which ``-march=native``
    compiles for: a checkout moved to another host builds anew."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path(cc: str) -> Path:
    """Where the built packer lives: keyed on the source, the compiler,
    the flags and the host's architecture (``-march=native``)."""
    h = hashlib.sha256(" ".join((cc, *CFLAGS, platform.machine())).encode())
    h.update(_cpu_flags())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libkt_hostpack.so"


def _build() -> Optional[Path]:
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("clang")
    if cc is None:
        return None
    out = library_path(cc)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(
            [cc, *CFLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True,
        )
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            ptr, size_t, u32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32
            lib.kt_pack_tiles_mt.argtypes = [ptr, ptr] + [size_t] * 4
            lib.kt_pack_tiles_mt.restype = None
            lib.kt_pack_tiles_range.argtypes = [ptr, ptr] + [size_t] * 5
            lib.kt_pack_tiles_range.restype = None
            lib.kt_cdc_chunk.argtypes = [
                ptr, size_t, size_t, size_t, size_t, u32, u32, ptr, size_t,
            ]
            lib.kt_cdc_chunk.restype = size_t
            _LIB = lib
        except (OSError, AttributeError):
            _LIB = None
        return _LIB


def have_native_packer() -> bool:
    return _load() is not None


def packer() -> str:
    """Which host packer :func:`pack_tiles` runs: ``"c"`` or ``"numpy"``."""
    return "c" if have_native_packer() else "numpy"


def cdc_chunk_native(
    data: np.ndarray,
    min_size: int,
    avg_size: int,
    max_size: int,
    mask_strict: int,
    mask_loose: int,
) -> Optional[np.ndarray]:
    """Sequential FastCDC cut offsets via the C chunker; None when no
    native library is available. ``data`` is a contiguous uint8 array;
    returns uint64 end offsets (exclusive)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    cap = n // min_size + 2
    cuts = np.empty(cap, dtype=np.uint64)
    ncuts = lib.kt_cdc_chunk(
        data.ctypes.data_as(ctypes.c_void_p), n, min_size, avg_size, max_size,
        mask_strict, mask_loose, cuts.ctypes.data_as(ctypes.c_void_p), cap,
    )
    return cuts[:ncuts]


def default_pack_threads() -> int:
    """Feeder thread count: all cores (the pack is memory-bound, L1-blocked,
    and embarrassingly parallel over 16-piece groups), overridable via
    ``KT_PACK_THREADS``."""
    env = os.environ.get("KT_PACK_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass  # malformed override: ignore, use the core count
    return max(1, os.cpu_count() or 1)


def _check_pack_args(
    data: np.ndarray, nb_out: int, out: np.ndarray | None
) -> tuple[np.ndarray, np.ndarray, int, int, int]:
    """Contiguity/dtype/size checks shared by every pack entry point.

    The C packer takes raw pointers: a strided view, a wrong dtype, or an
    undersized ``out`` would silently corrupt memory. Validated HERE, once,
    so the GIL-free pack loops stay branch-free."""
    if data.dtype != np.uint8 or data.ndim != 2:
        raise ValueError(f"pack: need [M, piece_len] uint8, got "
                         f"{data.dtype}{list(data.shape)}")
    m, piece_len = data.shape
    if m % 1024 or piece_len % 64:
        raise ValueError("pack: need M % 1024 == 0 and piece_len % 64 == 0")
    if nb_out < piece_len // 64:
        raise ValueError("pack: nb_out < piece blocks")
    t = m // 1024
    data = np.ascontiguousarray(data)
    if out is None:
        out = np.zeros((t, nb_out, 16, 1024), dtype=np.uint32)
    else:
        if out.dtype != np.uint32:
            raise ValueError(f"pack: out must be uint32, got {out.dtype}")
        if out.shape != (t, nb_out, 16, 1024):
            raise ValueError(
                f"pack: out shape {out.shape} != {(t, nb_out, 16, 1024)}"
            )
        if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
            raise ValueError("pack: out must be C-contiguous and writable")
    return data, out, m, piece_len, t


def pack_tiles(
    data: np.ndarray,
    nb_out: int,
    out: np.ndarray | None = None,
    threads: int | None = None,
) -> np.ndarray:
    """Pack [M, piece_len] uint8 pieces (M % 1024 == 0, piece_len % 64 == 0)
    into the word-major [T, nb_out, 16, 1024] big-endian u32 layout; blocks
    past ``piece_len // 64`` stay zero. Uses the C packer (multi-threaded
    over 16-piece groups) when available, NumPy otherwise."""
    data, out, m, piece_len, t = _check_pack_args(data, nb_out, out)
    nbd = piece_len // 64
    lib = _load()
    if lib is not None:
        lib.kt_pack_tiles_mt(
            data.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            m, piece_len, nb_out,
            default_pack_threads() if threads is None else max(1, threads),
        )
        return out
    w = data.reshape(t, 1024, nbd, 16, 4)
    be = (
        (w[..., 0].astype(np.uint32) << 24)
        | (w[..., 1].astype(np.uint32) << 16)
        | (w[..., 2].astype(np.uint32) << 8)
        | w[..., 3].astype(np.uint32)
    )  # [t, 1024, nbd, 16]
    out[:, :nbd] = be.transpose(0, 2, 3, 1)
    return out


def pack_tiles_range(
    data: np.ndarray, nb_out: int, out: np.ndarray, g_lo: int, g_hi: int,
) -> None:
    """Pack ONLY 16-piece groups ``[g_lo, g_hi)`` of ``data`` into ``out``
    on the calling thread -- the cooperative entry HashPool pack workers
    use: ctypes releases the GIL for the C call, so N workers packing
    disjoint ranges of one window scale with cores. Bounds are clamped to
    the group count; ``out`` must be the caller-zeroed full destination.
    Requires the native library."""
    data, out, m, piece_len, _ = _check_pack_args(data, nb_out, out)
    lib = _load()
    if lib is None:
        raise RuntimeError("pack_tiles_range: native packer unavailable")
    lib.kt_pack_tiles_range(
        data.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        m, piece_len, nb_out, max(0, g_lo), max(0, g_hi),
    )


def pack_tiles_pooled(
    data: np.ndarray, nb_out: int, pool, out: np.ndarray | None = None
) -> np.ndarray:
    """Pack one window through ``pool`` (a ``core.hasher.HashPool``): the
    group range splits across the pool's workers, each packing its
    contiguous stripe GIL-free through :func:`pack_tiles_range`. Falls back
    to the single-call path when the native library (or a multi-worker
    pool) is absent."""
    data, out, m, _, _ = _check_pack_args(data, nb_out, out)
    if pool is None or pool.workers < 2 or not have_native_packer():
        return pack_tiles(
            data, nb_out, out=out,
            threads=pool.workers if pool is not None else None,
        )

    def worker(lo: int, hi: int) -> None:
        pack_tiles_range(data, nb_out, out, lo, hi)

    pool.run_sharded(m // 16, worker)
    return out
