#!/usr/bin/env python3
"""Segment-size sweep of the port's relayout fold on one CUDA card.

    python3 chip_transpose_sweep.py [--out DIR]

``transpose_only_kernel`` (``kraken_tpu_torch/csrc/transpose.cu``) cuts
each piece into segments of ``kSegBytes`` and spreads the (piece, segment)
items over every SM. This sweep builds a copy of that source for each
segment size in ``SEG_KIB`` (only the constant differs; the shipped size
is among them), checks each against the plain version, and times each at
the JAX bench's 1024 x 256 KiB and at 132 x 1024 x 64 KiB: queued behind a
spin of the card (10 launches, the median of 3: device time) and on an
idle card (the median of 5: what one call costs its caller), the sizes in
turns (each size, then the sizes in reverse). Each launch zeroes its
output first, as the shipped launch does. Then it times the shipped
wrapper (``ops.transpose_cuda.transpose_only``) the same two ways and its
host time a call, at the bench shape. One JSON line per measurement, each
with its share of the byte bound (``chip_smoke.Card.bound_of``), the card's
name and power limit first. The builds go to ``DIR`` (default
``kraken_tpu_torch/_build/transpose_sweep``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from kraken_tpu_torch.ops import cuda_lib, transpose_cuda  # noqa: E402
from kraken_tpu_torch.ops.transpose_ref import transpose_only_ref  # noqa: E402

CSRC = REPO / "kraken_tpu_torch" / "csrc"
SHIPPED = "constexpr int64_t kSegBytes = 16 * 1024;"
SEG_KIB = (8, 16, 32)
SHAPES = (("bench_shape", 1024, 256 * 1024), ("full_card", 132 * 1024, 64 * 1024))


def build(out: Path) -> dict[int, ctypes.CDLL]:
    """One library a segment size, all ``nvcc``s started together."""
    src = (CSRC / "transpose.cu").read_text()
    if SHIPPED not in src:
        raise SystemExit(f"transpose.cu no longer holds {SHIPPED!r}")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kib in SEG_KIB:
        cu = out / f"transpose_seg{kib}.cu"
        cu.write_text(src.replace(SHIPPED, f"constexpr int64_t kSegBytes = {kib} * 1024;"))
        procs[kib] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *cuda_lib.LINK_FLAGS, "-I", str(CSRC),
             "-o", str(cu.with_suffix(".so")), str(cu)],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for kib, p in procs.items():
        log = p.communicate()[1]
        if p.returncode:
            raise SystemExit(f"nvcc, {kib} KiB segments:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(json.dumps({"seg_kib": kib, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(out / f"transpose_seg{kib}.so"))
        lib.transpose_only_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                              ctypes.c_void_p, ctypes.c_void_p]
        lib.transpose_only_launch.restype = ctypes.c_int
        libs[kib] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=REPO / "kraken_tpu_torch" / "_build" / "transpose_sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = chip_smoke.Card()
    print(card.name_power, flush=True)
    libs = build(args.out)
    dev = torch.device("cuda")

    def launch(kib, rows, out):
        rc = libs[kib].transpose_only_launch(rows.data_ptr(), rows.shape[0], rows.shape[1],
                                             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"transpose_only_launch ({kib} KiB) returned {rc}")

    def times(fn) -> dict:
        return {"queued_ms": statistics.median(chip_smoke.queued_ms(fn) for _ in range(3)),
                "idle_ms": statistics.median(chip_smoke.cuda_ms(fn) for _ in range(5))}

    for label, m, p in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        rows = torch.randint(0, 256, (m, p), dtype=torch.uint8, device=dev, generator=gen)
        want = transpose_only_ref(rows)
        out = torch.empty_like(want)
        bound_ms, bound_by = card.bound_of(m * p // 2, m * p + m * 32)
        for turn, order in enumerate((SEG_KIB, SEG_KIB[::-1])):
            for kib in order:
                launch(kib, rows, out)
                if not torch.equal(out, want):
                    raise AssertionError(f"{kib} KiB segments != the plain version at {label}")
                t = times(lambda k=kib: launch(k, rows, out))
                print(json.dumps({"shape": label, "seg_kib": kib, "turn": turn, **t,
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "share_of_bound_queued": bound_ms / t["queued_ms"]}), flush=True)
        if label == "bench_shape":
            if not torch.equal(transpose_cuda.transpose_only(rows), want):
                raise AssertionError("the shipped wrapper != the plain version")
            t = times(lambda: transpose_cuda.transpose_only(rows))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                transpose_cuda.transpose_only(rows)
            host_ms = (time.perf_counter() - t0) * 1e3 / 10
            torch.cuda.synchronize()
            print(json.dumps({"shape": label, "wrapper": "transpose_only", **t,
                              "host_ms_a_call": host_ms, "bound_ms": bound_ms,
                              "share_of_bound_queued": bound_ms / t["queued_ms"]}), flush=True)
        del rows, want, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
