#!/usr/bin/env python3
"""Rows-per-launch sweep of the port's SHA-256 kernel on one CUDA card.

    python3 chip_sha256_sweep.py [--out DIR]

The kernel hashes one row per thread, so a launch's time is one row's
serial chain until the card's SMs and issue slots fill. This sweep hashes
R rows of 64 KiB (1,025 blocks each) for R from 64 (one origin window) up
to 135,168 (1,024 rows per SM), timed with CUDA events (a warm-up, then
the median of 3), and prints one JSON line per R: the time, GB/s, and the
share of the kernel's operation bound (the same bound ``chip_smoke.py``
uses). Every launch's digests are checked against hashlib on a sample of
rows. First it prints the instruction count of each per-block loop of the
kernel's SASS (``cuobjdump -sass``); with ``--out DIR`` it also writes the
listing to ``DIR/sha256.sass``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
ROW = 64 * 1024
ROWS = (64, 512, 2048, 8448, 16896, 33792, 67584, 135168)


def loop_instruction_counts(sass: str) -> list[dict]:
    """Instructions in each loop of the SASS listing (a backward branch
    and everything from its target to it), with the opcode counts: the
    kernel's three per-block loops, one per load path (byte, 4-byte and
    16-byte aligned rows), in address order."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for addr, text in ins:
        target = re.search(r"BRA\s.*0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            ops: dict[str, int] = {}
            body = [t for a, t in ins if start <= a <= addr]
            for t in body:
                op = t.split()[1] if t.startswith("@") else t.split()[0]
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            loops.append({"instructions": len(body), "opcodes": ops})
    return loops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the kernel's SASS listing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_sha256_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import Card, cuda_ms
    from kraken_tpu_torch.ops import cuda_lib, sha256_cuda

    card = Card()
    print(card.name_power, flush=True)
    lib = cuda_lib.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
        check=True,
    ).stdout
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        Path(args.out, "sha256.sass").write_text(sass)
    print(json.dumps({"block_loops": loop_instruction_counts(sass)}), flush=True)
    x = torch.randint(
        0, 256, (ROWS[-1], ROW), dtype=torch.uint8, device="cuda"
    )
    rng = np.random.default_rng(0)
    for r in ROWS:
        rows = x[:r]
        words = sha256_cuda.sha256_uniform(rows)  # warm-up
        times = [cuda_ms(lambda: sha256_cuda.sha256_uniform(rows)) for _ in range(3)]
        ms = statistics.median(times)
        sample = rng.choice(r, size=min(r, 16), replace=False)
        host = rows[torch.as_tensor(sample, device="cuda")].cpu().numpy()
        got = words[torch.as_tensor(sample, device="cuda")].cpu().numpy()
        got = got.view(np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)
        for i in range(len(sample)):
            if bytes(got[i]) != hashlib.sha256(host[i].tobytes()).digest():
                raise AssertionError(f"rows={r}: row {sample[i]} != hashlib")
        bound_ms, bound_by = card.bound([ROW] * r)
        print(json.dumps({
            "rows": r, "row_bytes": ROW, "ms": times, "ms_median": ms,
            "gbps": r * ROW / ms / 1e6, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
