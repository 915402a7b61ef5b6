"""Wrappers of the hand-written SHA-256 kernel (``csrc/sha256.cu``).

Two wrappers launch the one ``__global__`` kernel, ``sha256_rows``:

- :func:`sha256_uniform` -- M equal-length pieces ``[M, P]`` uint8, the
  counterpart of ``kraken_tpu/ops/sha256_pallas.py`` ``sha256_tiles`` (the
  origin's metainfo generation). Rows are not padded up to a tile: the grid
  is ``ceil(M / 128)`` blocks.
- :func:`sha256_ragged` -- rows of any length in one flat buffer, given by
  offsets and lengths, the counterpart of ``kraken_tpu/ops/sha256.py``
  ``_sha256_ragged`` (the agent's verify). The host does no SHA padding.

What bounds the kernel, and what its design does about it, is noted at the
top of ``csrc/sha256.cu``.

A tensor on the CPU goes through the plain PyTorch version
(:mod:`kraken_tpu_torch.ops.sha256_ref`); a CUDA tensor
launches the kernel or raises. The kernel is built with ``nvcc`` at first
use, from the sources in this package only, into ``BUILD_DIR/<hash of the
sources and flags>/`` and loaded with ``ctypes``.

``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from kraken_tpu_torch.ops.sha256_ref import (
    sha256_rows_ref,
    sha256_uniform_ref,
    uniform_rows,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "sha256.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"sha256_uniform": 0, "sha256_ragged": 0}
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )


def library_path() -> Path:
    """Where the built kernel library lives: keyed on the sources and the
    flags, so an edit to either builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libkt_sha256.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    The compiler's resource report (``-Xptxas -v``) lands beside it as
    ``ptxas.log``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    r = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    (out.parent / "ptxas.log").write_text(r.stderr)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.sha256_rows_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.sha256_rows_launch.restype = ctypes.c_int
            lib.sha256_error_string.argtypes = [ctypes.c_int]
            lib.sha256_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sha256 takes cpu or cuda tensors, got {t.device}")


def _launch(
    name: str, flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    n = lengths.numel()
    out = torch.empty((n, 8), dtype=torch.int32, device=flat.device)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sha256_rows_launch(
            flat.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), n,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sha256_rows launch failed: {lib.sha256_error_string(rc).decode()}"
        )
    with _lock:
        LAUNCHES[name] += 1
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
