#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kraken_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It builds
the port's SHA-256 kernel from ``kraken_tpu_torch/csrc/`` (``nvcc``, a few
seconds), then runs five phases, each printing one JSON line; any failure
raises and the script exits non-zero without a result:

1. ``build``   -- the kernel library and the compiler's register report.
2. ``kernels`` -- the kernel against its plain PyTorch version and hashlib,
   on the card: lengths 0..257 (16-byte aligned and skewed starts, so all
   three load paths run), 37 x 4 KiB uniform pieces, 300 ragged pieces of
   0-70,000 bytes, one 4 MiB + 13 piece, and the main path's row counts
   (64 uniform rows; 64 ragged rows and a short one) at 16 KiB a row.
   Exact equality: SHA-256 admits no tolerance (``max_abs_err`` must be 0).
   The plain version runs ~2,000 eager PyTorch ops per 64-byte block, so a
   4 MiB row (65,537 blocks) is beyond it; such rows are held against
   hashlib alone, here and in the phases below.
3. ``origin``  -- the main path, origin side (BASELINE.json config 1): a
   1 GiB blob and a 1 GiB + 12,345 byte blob, seeded with numpy, uploaded
   and committed into a fresh ``CAStore``; ``Generator(store)`` with its
   default (``cuda``) hasher hashes every 4 MiB piece on the card; the
   digests must equal hashlib's.
4. ``agent``   -- the main path, agent side: the MetaInfo round-trips
   through serialize/deserialize; a corrupted piece is rejected; every
   piece goes through ``Torrent.write_piece`` and a ``BatchedVerifier``
   (``max_batch=1024``) on the card; the blob completes byte-identical.
5. ``batch``   -- ``hash_pieces`` over 1024 x 4 MiB pieces, 4 GiB on the
   device (BASELINE.json config 3 at a tenth): the kernel timed with CUDA
   events (a warm-up, then the median of 3) against its bound, and the
   hasher end to end from host memory.

The launch counters are zeroed just before the origin phase and read just
after the agent phase: both wrappers must have launched on the main path.
Then the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.

The bound of a launch is the larger of its bytes over the card's memory
rate (each input read once, each output written once) and its integer
operations over the card's INT32 rate: SMs x 64 INT32 lanes x the maximum
SM clock. SHA-256 needs ``OPS_PER_BLOCK`` integer operations per 64-byte
block (below), so it is bound by operations.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
PIECE = 4 * MiB
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT32_LANES_PER_SM = 64
# Integer operations of one SHA-256 compression with Hopper's three-input
# instructions (LOP3, IADD3) and funnel-shift rotates: 64 rounds x 14
# (Sigma1 4, Ch 1, Sigma0 4, Maj 1, adds 4) + 48 schedule steps x 10
# (sigma0 4, sigma1 4, adds 2) + 8 feed-forward adds + 16 byte swaps.
OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nblocks(length: int) -> int:
    return (length + 8) // 64 + 1


def words_to_bytes(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().view(np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class Card:
    """The card's peaks, read from the card itself."""

    def __init__(self):
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        self.name_power = q
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        self.sm_clock_hz = float(clk) * 1e6
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.int_ops_per_s = self.sms * INT32_LANES_PER_SM * self.sm_clock_hz

    def bound(self, lengths) -> tuple[float, str]:
        """Least time (ms) the card could take to hash rows of these
        lengths, and what bounds it."""
        ops = sum(nblocks(n) for n in lengths) * OPS_PER_BLOCK
        nbytes = sum(lengths) + len(lengths) * (8 + 8 + 32)  # rows, offsets, lengths, digests
        ops_ms = ops / self.int_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "kraken_tpu_torch" / "csrc" / "sha256.cu").is_file():
        print("chip_smoke: run it from a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    from kraken_tpu_torch import (
        AgentTorrentArchive, BatchedVerifier, CAStore, CPUPieceHasher, Digest,
        Generator, MetaInfo, OriginTorrentArchive, PieceError, TorchPieceHasher,
    )
    from kraken_tpu_torch.ops import sha256_cuda
    from kraken_tpu_torch.ops.sha256_cuda import sha256_ragged, sha256_uniform
    from kraken_tpu_torch.ops.sha256_ref import sha256_rows_ref, sha256_uniform_ref

    card = Card()
    dev = torch.device("cuda")
    oracle = CPUPieceHasher(workers=os.cpu_count() or 1)
    rng = np.random.default_rng(SEED)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = sha256_cuda.build()
    ptxas = [
        ln.strip() for ln in (lib.parent / "ptxas.log").read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(REPO)), "ptxas": ptxas})

    # -- 2. kernels --------------------------------------------------------
    def ragged_inputs(pieces, align=16, skew=0):
        offs, o = [], skew
        for p in pieces:
            offs.append(o)
            o += (len(p) + align - 1) // align * align
        flat = np.zeros(o + 1, dtype=np.uint8)
        for p, off in zip(pieces, offs):
            flat[off : off + len(p)] = np.frombuffer(p, dtype=np.uint8)
        return (torch.from_numpy(flat).to(dev), torch.tensor(offs, device=dev),
                torch.tensor([len(p) for p in pieces], device=dev))

    def hold(name, got, plain, pieces):
        """Kernel words == plain words (when run) == hashlib, exactly."""
        want = oracle.hash_batch(pieces)
        if not np.array_equal(words_to_bytes(got), want):
            raise AssertionError(f"{name}: kernel != hashlib")
        if plain is None:
            return None
        err = int(((got.long() & 0xFFFFFFFF) - (plain.long() & 0xFFFFFFFF)).abs().max())
        if err != 0 or not np.array_equal(words_to_bytes(plain), want):
            raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
        return err

    checks, errs = [], []
    pieces = [rng.bytes(n) for n in range(258)]
    for align, skew in ((16, 0), (1, 3)):
        args = ragged_inputs(pieces, align, skew)
        errs.append(hold(f"lengths 0..257 align {align}", sha256_ragged(*args),
                         sha256_rows_ref(*args), pieces))
        checks.append(f"ragged lengths 0..257, align {align} skew {skew}")
    rows = torch.from_numpy(rng.integers(0, 256, (37, 4 * KiB), dtype=np.uint8)).to(dev)
    host_rows = [bytes(r) for r in rows.cpu().numpy()]
    errs.append(hold("37 x 4 KiB", sha256_uniform(rows), sha256_uniform_ref(rows), host_rows))
    checks.append("uniform 37 x 4 KiB")
    pieces = [rng.bytes(int(n)) for n in rng.integers(0, 70_001, 300)]
    args = ragged_inputs(pieces)
    errs.append(hold("300 ragged", sha256_ragged(*args), sha256_rows_ref(*args), pieces))
    checks.append("ragged 300 x 0-70,000 B")
    big = [rng.bytes(4 * MiB + 13)]
    hold("4 MiB + 13", sha256_ragged(*ragged_inputs(big)), None, big)
    checks.append("ragged 1 x (4 MiB + 13), hashlib only")

    # The main path's row counts, at a length the plain version can run.
    cmp_rows = torch.from_numpy(rng.integers(0, 256, (64, 16 * KiB), dtype=np.uint8)).to(dev)
    cmp_host = [bytes(r) for r in cmp_rows.cpu().numpy()]
    sha256_uniform(cmp_rows)  # warm
    k_words = []
    uni_ms = cuda_ms(lambda: k_words.append(sha256_uniform(cmp_rows)))
    p_words = []
    uni_plain_ms = cuda_ms(lambda: p_words.append(sha256_uniform_ref(cmp_rows)))
    errs.append(hold("uniform 64 x 16 KiB", k_words[0], p_words[0], cmp_host))
    checks.append("uniform 64 x 16 KiB (main-path rows)")
    cmp_pieces = cmp_host + [rng.bytes(12_345)]
    args = ragged_inputs(cmp_pieces)
    k_words, p_words = [], []
    rag_ms = cuda_ms(lambda: k_words.append(sha256_ragged(*args)))
    rag_plain_ms = cuda_ms(lambda: p_words.append(sha256_rows_ref(*args)))
    errs.append(hold("ragged 64 x 16 KiB + 12,345", k_words[0], p_words[0], cmp_pieces))
    checks.append("ragged 64 x 16 KiB + 1 x 12,345 B (main-path rows)")
    max_abs_err = max(e for e in errs if e is not None)
    emit({"phase": "kernels", "checks": checks, "max_abs_err": max_abs_err,
          "uniform_64x16KiB": {"kernel_ms": uni_ms, "plain_ms": uni_plain_ms},
          "ragged_64x16KiB+12345": {"kernel_ms": rag_ms, "plain_ms": rag_plain_ms}})

    # -- 3 + 4. the main path: origin, then agent --------------------------
    work = REPO / ".chip_smoke_work"
    work.mkdir(exist_ok=True)
    sha256_cuda.reset_launches()
    main_start = time.perf_counter()
    for i, size in enumerate((GiB, GiB + 12_345)):
        root = tempfile.mkdtemp(dir=work)
        try:
            blob = np.random.default_rng(SEED + 1 + i).bytes(size)
            d = Digest.from_bytes(blob)
            ostore = CAStore(os.path.join(root, "origin"))
            uid = ostore.create_upload()
            ostore.write_upload_chunk(uid, 0, blob)
            ostore.commit_upload(uid, d, precomputed=d)

            before = dict(sha256_cuda.LAUNCHES)
            gen = Generator(ostore)
            if gen.hasher.name != "cuda":
                raise AssertionError(f"origin took the {gen.hasher.name} hasher")
            t0 = time.perf_counter()
            mi = gen.generate_sync(d)
            secs = time.perf_counter() - t0
            want = oracle.hash_pieces(blob, mi.piece_length)
            if mi.piece_hashes != want.tobytes() or mi.length != size:
                raise AssertionError("origin: piece digests != hashlib")
            emit({"phase": "origin", "blob_bytes": size, "pieces": mi.num_pieces,
                  "piece_length": mi.piece_length, "seconds": secs,
                  "gbps": size / secs / 1e9,
                  "launches": {k: sha256_cuda.LAUNCHES[k] - before[k] for k in before}})

            mi2 = MetaInfo.deserialize(mi.serialize())
            if mi2 != mi or mi2.info_hash != mi.info_hash:
                raise AssertionError("agent: MetaInfo did not round-trip")
            verifier = BatchedVerifier(max_batch=1024)
            if verifier.hasher.name != "cuda":
                raise AssertionError(f"agent took the {verifier.hasher.name} hasher")
            seed = OriginTorrentArchive(ostore, verifier).create_torrent(mi)
            astore = CAStore(os.path.join(root, "agent"))
            leech = AgentTorrentArchive(astore, verifier).create_torrent(mi2)
            got = [seed.read_piece(j) for j in range(mi.num_pieces)]
            bad = bytearray(got[1])
            bad[7] ^= 0x01
            before = dict(sha256_cuda.LAUNCHES)

            async def pull():
                try:
                    await leech.write_piece(1, bytes(bad))
                except PieceError:
                    pass
                else:
                    raise AssertionError("agent: a corrupted piece was accepted")
                t0 = time.perf_counter()
                done = await asyncio.gather(
                    *(leech.write_piece(j, p) for j, p in enumerate(got))
                )
                return time.perf_counter() - t0, done

            secs, done = asyncio.run(pull())
            if sum(done) != 1 or not leech.complete():
                raise AssertionError("agent: the torrent did not complete once")
            leech.close()
            seed.close()
            if astore.read_cache_file(d) != blob:
                raise AssertionError("agent: blob is not byte-identical")
            emit({"phase": "agent", "blob_bytes": size, "pieces": mi.num_pieces,
                  "seconds": secs, "gbps": size / secs / 1e9,
                  "launches": {k: sha256_cuda.LAUNCHES[k] - before[k] for k in before}})
        finally:
            shutil.rmtree(root, ignore_errors=True)
    main_launches = dict(sha256_cuda.LAUNCHES)
    main_secs = time.perf_counter() - main_start
    shutil.rmtree(work, ignore_errors=True)
    if not all(main_launches.values()):
        raise AssertionError(f"main path skipped a kernel: {main_launches}")

    # -- 5. batch: 1024 x 4 MiB on the device --------------------------------
    x = torch.randint(0, 256, (1024, PIECE), dtype=torch.uint8, device=dev)
    words = sha256_uniform(x)  # warm-up
    times = [cuda_ms(lambda: sha256_uniform(x)) for _ in range(3)]
    batch_ms = statistics.median(times)
    host = memoryview(x.cpu().numpy().reshape(-1))
    want = oracle.hash_pieces(host, PIECE)
    if not np.array_equal(words_to_bytes(words), want):
        raise AssertionError("batch: kernel != hashlib")
    batch_bound_ms, _ = card.bound([PIECE] * 1024)
    hasher = TorchPieceHasher(sub_batch_bytes=1024 * PIECE)
    t0 = time.perf_counter()
    via_hasher = hasher.hash_pieces(host, PIECE)
    hasher_secs = time.perf_counter() - t0
    if not np.array_equal(via_hasher, want):
        raise AssertionError("batch: hasher != hashlib")
    emit({"phase": "batch", "pieces": 1024, "piece_length": PIECE,
          "kernel_ms": times, "kernel_ms_median": batch_ms,
          "kernel_gbps": 1024 * PIECE / batch_ms / 1e6,
          "bound_ms": batch_bound_ms, "share_of_bound": batch_bound_ms / batch_ms,
          "hasher_seconds": hasher_secs,
          "hasher_gbps": 1024 * PIECE / hasher_secs / 1e9})

    # -- each wrapper at the main path's launch shape ------------------------
    # The origin's window and the agent's verify group are both 64 rows of
    # 4 MiB (256 MiB sub-batches of the cuda hasher).
    win = x[:64]
    sha256_uniform(win)
    uni_main_ms = statistics.median(cuda_ms(lambda: sha256_uniform(win)) for _ in range(3))
    flat = x.view(-1)[: 64 * PIECE]
    offs = torch.arange(64, device=dev) * PIECE
    lens = torch.full((64,), PIECE, device=dev)
    rag_main_ms = statistics.median(
        cuda_ms(lambda: sha256_ragged(flat, offs, lens)) for _ in range(3)
    )
    main_bound_ms, bound_by = card.bound([PIECE] * 64)
    del x, win, flat

    print(card.name_power, flush=True)
    common = {"route": "cuda", "source": "kraken_tpu_torch/csrc/sha256.cu",
              "max_abs_err": max_abs_err, "bound_ms": main_bound_ms,
              "bound_by": bound_by, "library_ms": None, "shape": "64 x 4 MiB",
              "plain_shape": "64 x 16 KiB (+1 x 12,345 B ragged)"}
    emit({"kernels": [
        {"name": "sha256_uniform", **common,
         "replaces": "kraken_tpu/ops/sha256_pallas.py:199",
         "launches": main_launches["sha256_uniform"], "ms": uni_main_ms,
         "plain_ms": uni_plain_ms, "ms_at_plain_shape": uni_ms},
        {"name": "sha256_ragged", **common,
         "replaces": "kraken_tpu/ops/sha256.py:140",
         "launches": main_launches["sha256_ragged"], "ms": rag_main_ms,
         "plain_ms": rag_plain_ms, "ms_at_plain_shape": rag_ms},
    ], "main_path_seconds": main_secs,
        "int_ops_per_s": card.int_ops_per_s, "sm_clock_hz": card.sm_clock_hz})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
