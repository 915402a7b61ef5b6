"""The port's kernel library: every CUDA source under ``csrc/``, built into
one shared object with a plain C interface and loaded with ``ctypes``.

The library is built at first use, from the sources in this package only
-- one ``nvcc`` per source, all started together, then one link -- into
``BUILD_DIR/<hash of the sources and flags>/libkt_kernels.so``, through a
temp file and an atomic rename. The compiler's resource report
(``-Xptxas -v``) lands beside it as ``ptxas.log``.

The wrappers (:mod:`~kraken_tpu_torch.ops.sha256_cuda`,
:mod:`~kraken_tpu_torch.ops.cdc_cuda`,
:mod:`~kraken_tpu_torch.ops.transpose_cuda`) launch through :func:`launch`, which
raises when the launch was refused; each keeps its own launch counter.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("sha256.cu", "sha256_packed.cu", "gear.cu", "transpose.cu")
)
HEADERS = (_PKG / "csrc" / "sha256_common.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

_P, _I64, _I32, _U32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
# C entry point -> its arguments before the trailing stream pointer.
_ENTRIES = {
    "sha256_rows_launch": (_P, _P, _P, _I64, _P),
    "sha256_packed_launch": (_P, _I64, _I64, _I64, _P),
    "pack_tiles_launch": (_P, _I64, _I64, _I64, _P),
    "gear_candidates_launch": (_P, _I64, _I32, _U32, _U32, _P),
    "transpose_only_launch": (_P, _I64, _I64, _P),
    "natural_loads_launch": (_P, _I64, _I64, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )


def library_path() -> Path:
    """Where the built kernel library lives: keyed on the sources and the
    flags, so an edit to either builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libkt_kernels.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}.{threading.get_ident()}"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{tag}")
    try:
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[1] for p in procs]
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc {src.name} failed ({p.returncode}):\n{log}")
        r = subprocess.run(
            [_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
        (out.parent / "ptxas.log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for entry, args in _ENTRIES.items():
                fn = getattr(lib, entry)
                fn.argtypes = [*args, _P]
                fn.restype = ctypes.c_int
            lib.sha256_error_string.argtypes = [ctypes.c_int]
            lib.sha256_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def load() -> ctypes.CDLL:
    """Build the kernel library if needed and load it into this process
    (a node calls it at start, so a card that cannot run the kernels
    fails the boot, not the first request)."""
    return _load()


def launch(entry: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``entry(*args, stream)`` on ``device``'s
    current stream; raise if the launch was refused."""
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: {lib.sha256_error_string(rc).decode()}")
