#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kraken_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It builds
the port's kernels from ``kraken_tpu_torch/csrc/`` (one ``nvcc`` per
source, all at once, a few seconds) and the host packer
(``kraken_tpu_torch/native/hostpack.c``), then runs ten phases, each
printing JSON lines; any failure raises and the script exits non-zero
without a result:

1. ``build``   -- the kernel library, the compiler's register report, the
   gear kernel's SASS instruction count, and which host packer was built
   (``c``, or ``numpy`` without a compiler).
2. ``kernels`` -- the SHA-256 kernel of ``csrc/sha256.cu`` against its
   plain PyTorch version and hashlib,
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
6. ``packed``  -- the two kernels of ``csrc/sha256_packed.cu`` against
   their plain versions and hashlib: the pack bit for bit at the full
   window (1024 x 4 MiB), 1024 x 576 B and 2048 x 64 B; the packed hash
   at 1024 x 16 KiB and 1024 x 576 B against the plain version, at
   1024 x 4 MiB against hashlib. Both kernels timed at 1024 x 4 MiB, the
   plain versions at the shape they ran, and the pack beside one PyTorch
   expression computing the same relayout.
7. ``ingest``  -- the origin's pipelined re-generate path,
   ``Generator(store, pipeline=IngestPipeline(get_hasher("cuda"), cfg))``:
   ``pack_mode: host`` with the shipped ``IngestConfig()`` on a 1 GiB blob
   of 4 MiB pieces (BASELINE.json config 1), then ``device`` and
   ``native`` on a 4 GiB + 12,345 byte blob with 4 GiB windows (config 3
   cut to one 1024-piece tile): the first window takes the packed path,
   the second is the ragged tail. Each run must give hashlib's digests,
   leave ``ingest_fallbacks_total`` unmoved, and launch exactly the
   kernels stated in ``INGEST_RUNS``.
8. ``cdc``     -- the gear kernel of ``csrc/gear.cu`` against its plain
   PyTorch version on the card, mask for mask: one 64 MiB window with a
   ragged tail from the blob's offset 0, one with 31 bytes of history;
   a blob of two windows and a ragged tail whose first 31 bytes hash onto
   the loose mask with zero history (the candidate lists of the windowed
   kernel route against one whole-blob plain pass); and a 1 GiB blob,
   whose cuts through the kernel route must equal the sequential C
   chunker's (``native.cdc_chunk_native``). The kernel is timed at the
   main path's window beside the plain pass and one PyTorch expression
   (the doubling in int32 with wraparound).
9. ``dedup``   -- the dedup plane's main path at BASELINE.json config 4's
   chunking (default ``CDCParams``, 64 KiB average chunks): a fresh
   ``CAStore`` and ``DedupIndex(store)``, which takes the card and the
   ``cuda`` hasher. A is 1 GiB, B is A with 4 KiB inserted at 256 MiB and
   1 MiB rewritten at 768 MiB, C is 256 MiB unrelated. The router
   calibrates on A (its measured rates and decision are printed), then is
   set to ``device`` so the kernel chunks every blob, and A, B and C are
   indexed. Each blob's spans must equal the C chunker's and each
   fingerprint hashlib's; ``similar(B)`` must rank A first at >= 0.9 and
   ``similar(C)`` return nothing above 0.1; the dedup ratio must reach
   0.45 once B is in (A and B alone; C, unrelated, then lowers it); the
   gear kernel must launch once per 64 MiB window and the ragged SHA-256
   at least once. Each blob's wall splits into chunk, hash and sketch
   seconds. The ragged SHA-256 is timed at the chunk shape.
10. ``relayout`` -- the diagnostic kernel of ``csrc/transpose.cu`` (the
   natural SHA-256 kernel's loads with no rounds) against its plain
   version, word for word: 1024 x 512 B, 2048 x 1 KiB, and a
   piece-distinct 2048 x 512 B input that pins the ``[t, i, s, l]``
   layout to its closed form. Then the natural-vs-packed gap decomposition
   (``kraken_tpu_torch.bench.transpose.decompose``) at the JAX bench's
   shape, 1024 x 256 KiB, and at 132 x 1024 x 64 KiB: the transpose-only,
   natural and packed kernels timed, each beside its bound; the kernel
   held against its plain version and the natural digests against the
   packed ones at both shapes. Each decomposition is a path of its own: the
   counters are zeroed just before it and read just after, and every
   kernel it drives must have launched exactly as often as it times them.

Phases 8 and 10 read the SM clock right after their timed launches.

The launch counters are zeroed just before each main path (origin +
agent; each ingest run; the dedup indexing; each decomposition) and read
just after it: every
wrapper must have launched on its path. Then the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.

The bound of a launch is the larger of its bytes over the card's memory
rate (each input read once, each output written once) and its integer
operations over the card's INT32 rate: SMs x 64 INT32 lanes x the maximum
SM clock. SHA-256 needs ``OPS_PER_BLOCK`` integer operations per 64-byte
block (below), so it is bound by operations; the pack moves bytes; the
gear pass needs ``GEAR_OPS_PER_BYTE`` a byte against 2 bytes moved.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# The packed hash reads big-endian words: no byte swaps.
OPS_PER_BLOCK_PACKED = OPS_PER_BLOCK - 16
TAIL = 12_345
# The relayout decomposition's full-card shape: 132 tiles of 1024 pieces,
# 1,024 pieces an SM, chip_sha256_sweep.py's top point.
FULL_TILES = 132
# Integer operations of the gear pass a byte, in the rolling form: the gear
# map 6 (multiply-add, shift, xor, multiply, shift, xor), one shift-add, and
# two mask tests of 2 (and, compare).
GEAR_OPS_PER_BYTE = 6 + 1 + 2 * 2
# The ingest runs: (pack mode, blob, window bytes, the launches each wrapper
# must make). "config 1" is the 1 GiB blob of 4 MiB pieces: 16 windows of
# 16 pieces, one uniform launch each. "tile" is 1024 pieces of 4 MiB and a
# 12,345 byte tail: one packed window, then the tail.
INGEST_RUNS = (
    ("host", "config 1", 64 * MiB,
     {"sha256_uniform": 16, "sha256_ragged": 0,
      "pack_tiles_device": 0, "sha256_packed_tiles": 0}),
    ("device", "tile", 1024 * PIECE,
     {"sha256_uniform": 0, "sha256_ragged": 1,
      "pack_tiles_device": 1, "sha256_packed_tiles": 1}),
    ("native", "tile", 1024 * PIECE,
     {"sha256_uniform": 0, "sha256_ragged": 1,
      "pack_tiles_device": 0, "sha256_packed_tiles": 1}),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nblocks(length: int) -> int:
    return (length + 8) // 64 + 1


def words_to_bytes(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().view(np.uint32).astype(">u4").view(np.uint8).reshape(-1, 32)


def sass_instructions(sass: str, kernel: str) -> int:
    """Instructions of one kernel's function in a ``cuobjdump -sass``
    listing."""
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            count += 1
    return count


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def smi(query: str, *fmt: str) -> str:
    """The first card's ``nvidia-smi --query-gpu`` answer."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Card:
    """The card's peaks, read from the card itself."""

    def __init__(self):
        self.name_power = smi("name,power.limit")
        self.sm_clock_hz = float(smi("clocks.max.sm", "nounits")) * 1e6
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.int_ops_per_s = self.sms * INT32_LANES_PER_SM * self.sm_clock_hz

    def bound(self, lengths) -> tuple[float, str]:
        """Least time (ms) the card could take to hash rows of these
        lengths, and what bounds it."""
        ops = sum(nblocks(n) for n in lengths) * OPS_PER_BLOCK
        nbytes = sum(lengths) + len(lengths) * (8 + 8 + 32)  # rows, offsets, lengths, digests
        return self.bound_of(ops, nbytes)

    def bound_of(self, ops: float, nbytes: float) -> tuple[float, str]:
        """Least time (ms) for ``ops`` integer operations over ``nbytes``
        moved, and which of the two bounds it."""
        ops_ms = ops / self.int_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")

    @staticmethod
    def sm_clock_mhz() -> float:
        """The SM clock now, read right after a timed launch: a short launch
        on a card whose clock has not ramped reads slow."""
        return float(smi("clocks.sm", "nounits"))


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
        Digester, Generator, IngestConfig, IngestPipeline, MetaInfo,
        OriginTorrentArchive, PieceError, PieceLengthConfig, TorchPieceHasher,
        TorrentMetaMetadata, get_hasher, native,
    )
    from kraken_tpu_torch import CDCParams, DedupIndex, chunk
    from kraken_tpu_torch.bench.transpose import REPS, decompose
    from kraken_tpu_torch.ops import cdc_cuda, cuda_lib, sha256_cuda, transpose_cuda
    from kraken_tpu_torch.ops.cdc_cuda import LEAD, candidate_indices, gear_mask, padded
    from kraken_tpu_torch.ops.cdc_ref import gear_candidates_ref, gear_mask_ref
    from kraken_tpu_torch.ops.sha256_cuda import (
        pack_tiles_device, sha256_packed_tiles, sha256_ragged, sha256_uniform,
    )
    from kraken_tpu_torch.ops.sha256_ref import (
        pack_tiles_ref, packed_nb, sha256_packed_ref, sha256_rows_ref,
        sha256_uniform_ref,
    )
    from kraken_tpu_torch.ops.transpose_cuda import transpose_only
    from kraken_tpu_torch.ops.transpose_ref import transpose_only_ref
    from kraken_tpu_torch.utils.metrics import REGISTRY

    card = Card()
    dev = torch.device("cuda")
    oracle = CPUPieceHasher(workers=os.cpu_count() or 1)
    rng = np.random.default_rng(SEED)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # the kernels and the host packer at once
        packer = ex.submit(native.packer)
        lib = cuda_lib.build()
        packer = packer.result()
    build_secs = time.perf_counter() - t0
    ptxas = [
        ln.strip() for ln in (lib.parent / "ptxas.log").read_text().splitlines()
        if "entry function" in ln or "registers" in ln or "spill" in ln
    ]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    # The gear kernel is unrolled and loop-free but for its 5-lap load
    # loop: per position, its instructions times a block's 256 threads over
    # its 4,096 positions (the load loop counted once: a lower bound).
    gear_sass = sass_instructions(sass, "gear_mask_kernel")
    emit({"phase": "build", "seconds": build_secs,
          "library": str(lib.relative_to(REPO)), "ptxas": ptxas,
          "gear_sass_instructions": gear_sass,
          "gear_sass_per_byte": gear_sass * 256 / cdc_cuda.TILE,
          "host_packer": packer})

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
    transpose_cuda.reset_launches()
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
    main_launches = {**sha256_cuda.LAUNCHES, **transpose_cuda.LAUNCHES}
    main_secs = time.perf_counter() - main_start
    shutil.rmtree(work, ignore_errors=True)
    if not (main_launches["sha256_uniform"] and main_launches["sha256_ragged"]):
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
    del win, flat

    # -- 6. packed: the two kernels of csrc/sha256_packed.cu ------------------
    def word_err(a, b):
        """max |a - b| over uint32 words (0 when equal)."""
        if torch.equal(a, b):
            return 0
        return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max())

    checks, pack_errs, packed_errs = [], [], []
    for m, p in ((1024, 576), (2048, 64)):
        rows = torch.from_numpy(rng.integers(0, 256, (m, p), dtype=np.uint8)).to(dev)
        got = pack_tiles_device(rows, p // 64)
        pack_errs.append(word_err(got, pack_tiles_ref(rows, p // 64)))
        checks.append(f"pack {m} x {p} B vs plain")
        if m == 1024:
            pieces = [bytes(r) for r in rows.cpu().numpy()]
            packed_errs.append(hold(f"packed {m} x {p} B", sha256_packed_tiles(got, p // 64),
                                    sha256_packed_ref(got, p // 64), pieces))
            checks.append(f"packed hash {m} x {p} B vs plain and hashlib")

    rows = torch.from_numpy(rng.integers(0, 256, (1024, 16 * KiB), dtype=np.uint8)).to(dev)
    pk16 = pack_tiles_device(rows, 16 * KiB // 64)
    sha256_packed_tiles(pk16, 256)  # warm
    k_words, p_words = [], []
    packed16_ms = cuda_ms(lambda: k_words.append(sha256_packed_tiles(pk16, 256)))
    packed_plain_ms = cuda_ms(lambda: p_words.append(sha256_packed_ref(pk16, 256)))
    packed_errs.append(hold("packed 1024 x 16 KiB", k_words[0], p_words[0],
                            [bytes(r) for r in rows.cpu().numpy()]))
    checks.append("packed hash 1024 x 16 KiB vs plain and hashlib")
    del rows, pk16, k_words, p_words

    # The full window: 1024 x 4 MiB, the pieces of the batch phase.
    nb = PIECE // 64
    pk = pack_tiles_device(x, nb)  # warm-up, kept
    pack_ms = statistics.median(cuda_ms(lambda: pack_tiles_device(x, nb)) for _ in range(3))
    plain = []
    pack_plain_ms = cuda_ms(lambda: plain.append(pack_tiles_ref(x, nb)))
    pack_errs.append(word_err(pk, plain[0]))
    checks.append("pack 1024 x 4 MiB vs plain")
    del plain

    def library_pack():
        """One PyTorch expression for the relayout: a byte flip, then a
        permute copied into a zeroed output."""
        out = torch.zeros((1, packed_nb(nb), 16, 1024), dtype=torch.int32, device=dev)
        out[:, :nb] = (x.view(1, 1024, nb, 16, 4).flip(-1).view(torch.int32)
                       .view(1, 1024, nb, 16).permute(0, 2, 3, 1))
        return out

    if word_err(library_pack().view(pk.shape), pk):
        raise AssertionError("the library expression is not the pack")
    pack_library_ms = statistics.median(cuda_ms(library_pack) for _ in range(3))
    words = sha256_packed_tiles(pk, nb)  # warm-up
    packed_ms = statistics.median(cuda_ms(lambda: sha256_packed_tiles(pk, nb)) for _ in range(3))
    if not np.array_equal(words_to_bytes(words), want):
        raise AssertionError("packed 1024 x 4 MiB: kernel != hashlib")
    checks.append("packed hash 1024 x 4 MiB vs hashlib")
    if any(pack_errs) or any(packed_errs):
        raise AssertionError(f"packed kernels disagree: {pack_errs} {packed_errs}")
    nbp = packed_nb(nb)
    pack_bound_ms, pack_bound_by = card.bound_of(
        1024 * nb * 16, 1024 * PIECE + 1024 * nbp * 64  # byte swaps; read P, write NB * 64
    )
    packed_bound_ms, packed_bound_by = card.bound_of(
        1024 * (nb + 1) * OPS_PER_BLOCK_PACKED, 1024 * nb * 64 + 1024 * 32
    )
    emit({"phase": "packed", "checks": checks, "max_abs_err": 0,
          "pack_1024x4MiB": {"kernel_ms": pack_ms, "plain_ms": pack_plain_ms,
                             "library_ms": pack_library_ms, "bound_ms": pack_bound_ms,
                             "gbps": 2 * 1024 * PIECE / pack_ms / 1e6},
          "packed_1024x4MiB": {"kernel_ms": packed_ms, "bound_ms": packed_bound_ms,
                               "share_of_bound": packed_bound_ms / packed_ms,
                               "gbps": 1024 * PIECE / packed_ms / 1e6},
          "packed_1024x16KiB": {"kernel_ms": packed16_ms, "plain_ms": packed_plain_ms}})
    del x, pk, words
    torch.cuda.empty_cache()

    # -- 7. ingest: the origin's pipelined re-generate path -------------------
    def fallbacks():
        return REGISTRY.counter("ingest_fallbacks_total").value(reason="failpoint")

    def put(store, parts):
        dg, uid, off = Digester(), store.create_upload(), 0
        for part in parts:
            store.write_upload_chunk(uid, off, part)
            dg.update(part)
            off += len(part)
        d = dg.digest()
        store.commit_upload(uid, d, precomputed=d)
        return d

    blob1 = np.random.default_rng(SEED + 1).bytes(GiB)
    tail = rng.bytes(TAIL)
    blobs = {  # name -> (parts, hashlib's piece digests)
        "config 1": ([blob1], oracle.hash_pieces(blob1, PIECE)),
        "tile": ([host, tail], np.concatenate([want, oracle.hash_pieces(tail, PIECE)])),
    }
    work.mkdir(exist_ok=True)
    ingest_launches = dict.fromkeys(sha256_cuda.LAUNCHES, 0)
    ingest_secs, root, stored = 0.0, None, None
    for mode, blob, window, expect in INGEST_RUNS:
        if blob != stored:  # a new blob: the last one's 4 GiB files go first
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)
            root, stored = tempfile.mkdtemp(dir=work), blob
            store = CAStore(root)
            parts, want_pieces = blobs[blob]
            size = sum(len(p) for p in parts)
            d = put(store, parts)
        cfg = IngestConfig(window_bytes=window, windows_in_flight=2, pack_mode=mode)
        pipe = IngestPipeline(get_hasher("cuda"), cfg)
        sessions = []
        open_session = pipe.session
        pipe.session = lambda plen: sessions.append(open_session(plen)) or sessions[-1]
        gen = Generator(store, piece_lengths=PieceLengthConfig(((0, PIECE),)), pipeline=pipe)
        if gen.hasher.name != "cuda":
            raise AssertionError(f"ingest took the {gen.hasher.name} hasher")
        store.delete_metadata(d, TorrentMetaMetadata)
        fb0 = fallbacks()
        sha256_cuda.reset_launches()
        t0 = time.perf_counter()
        mi = gen.generate_sync(d)
        secs = time.perf_counter() - t0
        launches = dict(sha256_cuda.LAUNCHES)
        ses = sessions[0]
        if len(sessions) != 1 or mi.length != size or mi.piece_hashes != want_pieces.tobytes():
            raise AssertionError(f"ingest {mode}: piece digests != hashlib")
        if fallbacks() != fb0 or ses._fell_back:
            raise AssertionError(f"ingest {mode}: the device path fell back to hashlib")
        if launches != expect:
            raise AssertionError(f"ingest {mode}: launches {launches} != {expect}")
        for k in ingest_launches:
            ingest_launches[k] += launches[k]
        ingest_secs += secs
        emit({"phase": "ingest", "pack_mode": mode, "blob": blob, "blob_bytes": size,
              "pieces": mi.num_pieces, "window_bytes": ses.window_bytes,
              "windows_in_flight": cfg.windows_in_flight, "windows": ses.windows,
              "seconds": secs, "gbps": size / secs / 1e9,
              "stage_seconds": ses.stage_seconds, "overlap_ratio": ses.overlap_ratio(),
              "launches": launches, "pack_workers": cfg.pack_workers,
              "host_packer": native.packer() if mode == "native" else None})
        del pipe, gen, sessions, ses, open_session
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    del blobs, host, blob1

    # -- 8. cdc: the gear kernel against its plain version --------------------
    params = CDCParams()
    ms_, ml_ = params.mask_strict, params.mask_loose
    win = cdc_cuda.WINDOW_BYTES
    checks, gear_errs = [], []

    def mask_err(got, want):
        """max |kernel - plain| over the mask bytes (0 when equal)."""
        return 0 if torch.equal(got, want) else int((got.int() - want.int()).abs().max())

    for n, hist in ((win - TAIL, 0), (win, 31)):
        buf = torch.from_numpy(rng.integers(0, 256, LEAD + padded(n), dtype=np.uint8)).to(dev)
        gear_errs.append(mask_err(gear_mask(buf, n, hist, ms_, ml_),
                                  gear_mask_ref(buf, n, hist, ms_, ml_, LEAD)))
        checks.append(f"one window of {n} B, {hist} B of history, vs plain")
    # The main path's launch: a whole 64 MiB window after the first.
    gear_mask(buf, win, 31, ms_, ml_)  # warm
    gear_ms = statistics.median(cuda_ms(lambda: gear_mask(buf, win, 31, ms_, ml_))
                                for _ in range(3))
    gear_clock_mhz = card.sm_clock_mhz()
    gear_plain_ms = cuda_ms(lambda: gear_mask_ref(buf, win, 31, ms_, ml_, LEAD))

    def i32(v):
        return v - (1 << 32) if v >= 1 << 31 else v

    def library_gear():
        """One PyTorch expression for the window's masks: the gear map and
        the log-doubling in int32 with wraparound, then both mask tests."""
        x = buf[LEAD - 31 : LEAD + win].to(torch.int32)
        x = (x + 1) * i32(0x9E3779B1)
        x = x ^ ((x >> 15) & 0x1FFFF)
        x = x * i32(0x85EBCA77)
        h = x ^ ((x >> 13) & 0x7FFFF)
        step = 1
        while step < 32:
            h = h + (torch.cat([h.new_zeros(step), h[:-step]]) << step)
            step *= 2
        h = h[31:]
        return ((h & i32(ms_)) == 0).to(torch.uint8) | (((h & i32(ml_)) == 0).to(torch.uint8) << 1)

    if mask_err(library_gear(), gear_mask(buf, win, 31, ms_, ml_)):
        raise AssertionError("the library expression is not the gear pass")
    gear_library_ms = statistics.median(cuda_ms(library_gear) for _ in range(3))
    gear_bound_ms, gear_bound_by = card.bound_of(win * GEAR_OPS_PER_BYTE, 2 * win + 31)
    del buf

    # Two windows and a ragged tail, planted: the first 31 bytes hash onto
    # the loose mask with zero history (the seeds are searched on the card
    # with the plain pass), where a lead taken as zero bytes would diverge.
    n3 = 2 * win + TAIL
    arr3 = rng.integers(0, 256, n3, dtype=np.uint8)
    for seed in range(10_000):
        prefix = np.random.default_rng(seed).integers(0, 256, 31, dtype=np.uint8)
        if bool(gear_candidates_ref(torch.from_numpy(prefix).to(dev), ms_, ml_)[1].any()):
            arr3[:31] = prefix
            break
    else:
        raise AssertionError("cdc: no early-candidate prefix found")
    before = cdc_cuda.LAUNCHES["gear_candidates"]
    got3 = candidate_indices(arr3, n3, params, dev)
    if cdc_cuda.LAUNCHES["gear_candidates"] - before != 3:
        raise AssertionError("cdc: the planted blob did not take 3 launches")
    want3 = [torch.nonzero(m).squeeze(1).cpu().numpy()
             for m in gear_candidates_ref(torch.from_numpy(arr3).to(dev), ms_, ml_)]
    if not all(np.array_equal(g, w) for g, w in zip(got3, want3)) or not got3[1][0] < 31:
        raise AssertionError("cdc: windowed kernel candidates != whole-blob plain pass")
    checks.append(f"planted blob of {n3} B (3 windows) vs one whole-blob plain pass, "
                  f"seed {seed}, first loose candidate at {int(got3[1][0])}")
    del arr3, want3

    # 1 GiB: the kernel route's cuts against the sequential C chunker.
    blob_a = np.random.default_rng(SEED + 10).bytes(GiB)
    native_cuts = {}

    def c_cuts(name, data):
        t0 = time.perf_counter()
        cuts = native.cdc_chunk_native(np.frombuffer(data, dtype=np.uint8), params.min_size,
                                       params.avg_size, params.max_size, ms_, ml_)
        native_cuts[name] = (cuts.tolist(), time.perf_counter() - t0)
        return native_cuts[name][0]

    t0 = time.perf_counter()
    cuts_a = chunk(blob_a, params)
    chunk_secs = time.perf_counter() - t0
    if cuts_a != c_cuts("A", blob_a):
        raise AssertionError("cdc: 1 GiB kernel-route cuts != the C chunker's")
    checks.append(f"1 GiB: {len(cuts_a)} cuts through the kernel route == C chunker")
    gear_err = max(gear_errs)
    if gear_err:
        raise AssertionError(f"cdc: gear kernel != plain version (max abs err {gear_err})")
    emit({"phase": "cdc", "checks": checks, "max_abs_err": gear_err,
          "window_64MiB": {"kernel_ms": gear_ms, "plain_ms": gear_plain_ms,
                           "library_ms": gear_library_ms, "bound_ms": gear_bound_ms,
                           "bound_by": gear_bound_by,
                           "share_of_bound": gear_bound_ms / gear_ms,
                           "gbps": win / gear_ms / 1e6, "sm_clock_mhz": gear_clock_mhz},
          "chunk_1GiB": {"seconds": chunk_secs, "gbps": GiB / chunk_secs / 1e9,
                         "c_chunker_seconds": native_cuts["A"][1],
                         "c_chunker_gbps": GiB / native_cuts["A"][1] / 1e9}})

    # -- 9. dedup: the dedup plane's main path --------------------------------
    mut = np.random.default_rng(SEED + 11)
    blob_b = b"".join((blob_a[: 256 * MiB], mut.bytes(4 * KiB), blob_a[256 * MiB : 768 * MiB],
                       mut.bytes(MiB), blob_a[769 * MiB :]))
    blob_c = np.random.default_rng(SEED + 12).bytes(256 * MiB)
    blobs = {"A": blob_a, "B": blob_b, "C": blob_c}
    work.mkdir(exist_ok=True)
    store = CAStore(tempfile.mkdtemp(dir=work))
    digests = {name: put(store, [data]) for name, data in blobs.items()}
    index = DedupIndex(store)
    if index.hasher.name != "cuda" or index.device.type != "cuda":
        raise AssertionError("dedup did not take the card and the cuda hasher")
    router = index.router
    decision = router.calibrate(blob_a)
    emit({"phase": "dedup", "calibration": {"decision": decision, "measured": router.measured,
                                            "sample_bytes": router.sample_bytes}})
    router.decision = "device"

    stage = {}

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stage[name] += time.perf_counter() - t0
            return out
        return run

    router.spans = timed("chunk", router.spans)
    index.hasher.hash_batch = timed("hash", index.hasher.hash_batch)
    index.minhasher.sketch = timed("sketch", index.minhasher.sketch)
    sha256_cuda.reset_launches()
    cdc_cuda.reset_launches()
    dedup_start = time.perf_counter()
    records, ratios = {}, {}
    for name, data in blobs.items():
        stage.update(chunk=0.0, hash=0.0, sketch=0.0)
        t0 = time.perf_counter()
        records[name] = index.add_blob_sync(digests[name])
        secs = time.perf_counter() - t0
        ratios[name] = index.dedup_ratio
        emit({"phase": "dedup", "blob": name, "blob_bytes": len(data),
              "chunks": int(records[name].fps.size), "seconds": secs,
              "gbps": len(data) / secs / 1e9, "stage_seconds": dict(stage),
              "chunk_gbps": len(data) / stage["chunk"] / 1e9,
              "dedup_ratio": ratios[name]})
    dedup_secs = time.perf_counter() - dedup_start
    dedup_launches = {**sha256_cuda.LAUNCHES, **cdc_cuda.LAUNCHES}
    windows = sum(-(-len(d) // win) for d in blobs.values())
    if dedup_launches["gear_candidates"] != windows or not dedup_launches["sha256_ragged"]:
        raise AssertionError(f"dedup: launches {dedup_launches}, {windows} windows")
    for name, data in blobs.items():
        rec = records[name]
        ends = np.cumsum(rec.sizes.astype(np.int64)).tolist()
        want = native_cuts[name][0] if name in native_cuts else c_cuts(name, data)
        if ends != want:
            raise AssertionError(f"dedup: {name}'s spans != the C chunker's")
        view = memoryview(data)
        starts = [0] + ends[:-1]
        digs = oracle.hash_batch([view[s:e] for s, e in zip(starts, ends)])
        if not np.array_equal(digs[:, :8].copy().view(">u8").reshape(-1), rec.fps):
            raise AssertionError(f"dedup: {name}'s fingerprints != hashlib's")
    sim_b = index.similar(digests["B"])
    sim_c = index.similar(digests["C"])
    if not sim_b or sim_b[0]["digest"] != digests["A"].hex or sim_b[0]["score"] < 0.9:
        raise AssertionError(f"dedup: similar(B) = {sim_b}")
    if any(h["score"] > 0.1 for h in sim_c):
        raise AssertionError(f"dedup: similar(C) = {sim_c}")
    if ratios["B"] < 0.45:
        raise AssertionError(f"dedup: ratio {ratios['B']} after A and B")

    # The ragged SHA-256 at the chunk shape: A's chunks as the cuda hasher
    # stages them (starts 16-byte aligned), in one launch and in the
    # hasher's 256 MiB groups.
    sizes_a = records["A"].sizes.astype(np.int64)
    aligned = (sizes_a + 15) // 16 * 16
    offs = np.concatenate([[0], np.cumsum(aligned)[:-1]])
    flat = np.zeros(int(aligned.sum()), dtype=np.uint8)
    src = np.frombuffer(blob_a, dtype=np.uint8)
    for o, s, n in zip(offs.tolist(), [0] + np.cumsum(sizes_a)[:-1].tolist(), sizes_a.tolist()):
        flat[o : o + n] = src[s : s + n]
    flat_d = torch.from_numpy(flat).to(dev)
    offs_d, lens_d = torch.from_numpy(offs).to(dev), torch.from_numpy(sizes_a).to(dev)
    group = int(np.searchsorted(np.cumsum(aligned), 256 * MiB, side="right"))
    sha256_ragged(flat_d, offs_d, lens_d)  # warm
    rag_chunks_ms = statistics.median(
        cuda_ms(lambda: sha256_ragged(flat_d, offs_d, lens_d)) for _ in range(3))
    rag_group_ms = statistics.median(
        cuda_ms(lambda: sha256_ragged(flat_d, offs_d[:group], lens_d[:group])) for _ in range(3))
    rag_chunks_bound, _ = card.bound(sizes_a.tolist())
    rag_group_bound, _ = card.bound(sizes_a[:group].tolist())
    emit({"phase": "dedup", "launches": dedup_launches, "windows": windows,
          "seconds": dedup_secs, "similar_B": sim_b, "similar_C": sim_c,
          "dedup_ratio": index.dedup_ratio, "stats": index.stats(),
          "sha256_ragged_chunk_shape": {
              "rows": int(sizes_a.size), "min_row": int(sizes_a.min()),
              "max_row": int(sizes_a.max()), "kernel_ms": rag_chunks_ms,
              "bound_ms": rag_chunks_bound, "gbps": GiB / rag_chunks_ms / 1e6,
              "group_rows": group, "group_kernel_ms": rag_group_ms,
              "group_bound_ms": rag_group_bound}})
    del flat, flat_d, blobs, blob_a, blob_b, blob_c, index, records
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. relayout: the diagnostic kernel and the gap decomposition -------
    checks, t_errs = [], []
    for m, p in ((1024, 512), (2048, KiB)):
        rows = torch.from_numpy(rng.integers(0, 256, (m, p), dtype=np.uint8)).to(dev)
        t_errs.append(word_err(transpose_only(rows), transpose_only_ref(rows)))
        checks.append(f"{m} x {p} B vs plain")
    # Piece-distinct: only the first line of piece q is not zero, and its
    # big-endian word i is q * 8 + i, so word i of piece t * 1024 + s * 128
    # + l must come out at [t, i, s, l] as exactly that.
    m = 2048
    first = ((np.arange(m, dtype=np.uint32)[:, None] << 3) | np.arange(8, dtype=np.uint32))
    host_rows = np.zeros((m, 512), dtype=np.uint8)
    host_rows[:, :32] = first.astype(">u4").view(np.uint8)
    rows = torch.from_numpy(host_rows).to(dev)
    got = transpose_only(rows)
    t_errs.append(word_err(got, transpose_only_ref(rows)))
    layout = first.reshape(m // 1024, 8, 128, 8).transpose(0, 3, 1, 2).view(np.int32)
    if not np.array_equal(got.cpu().numpy(), layout):
        raise AssertionError("relayout: the [t, i, s, l] layout is wrong")
    checks.append(f"piece-distinct {m} x 512 B vs plain and the closed form")
    del rows, got

    def legs(r):
        """Each leg of a decomposition: ms, GB/s of input, bound."""
        m, p = r["pieces"], r["piece_len"]
        nb = p // 64
        bounds = {
            "transpose_only": card.bound_of(m * p // 2, m * p + m * 32),  # bswap + xor a word
            "natural": card.bound([p] * m),
            "rounds_only_packed": card.bound_of(m * (nb + 1) * OPS_PER_BLOCK_PACKED,
                                                m * p + m * 32),
        }
        return {name: {"ms": r[f"{name}_ms"], "gbps": r[f"{name}_gbps"], "bound_ms": b,
                       "bound_by": by, "share_of_bound": b / r[f"{name}_ms"]}
                for name, (b, by) in bounds.items()}

    # A warm-up and REPS timed launches a leg, one pack, no ragged hash.
    expect = {"sha256_uniform": REPS + 1, "sha256_ragged": 0, "pack_tiles_device": 1,
              "sha256_packed_tiles": REPS + 1, "transpose_only": REPS + 1}
    decomps, relayout_launches = {}, {}
    for label, tiles, p in (("bench_shape", 1, 256 * KiB), ("full_card", FULL_TILES, 64 * KiB)):
        t0 = time.perf_counter()
        sha256_cuda.reset_launches()
        transpose_cuda.reset_launches()
        r = decompose(tiles, p)
        launches = {**sha256_cuda.LAUNCHES, **transpose_cuda.LAUNCHES}
        clock = card.sm_clock_mhz()  # decompose raised if a check failed
        if launches != expect:
            raise AssertionError(f"relayout {label}: launches {launches} != {expect}")
        checks.append(f"decompose {tiles} x 1024 x {p} B: kernel vs plain, natural vs packed digests")
        decomps[label] = r
        relayout_launches[label] = launches["transpose_only"]
        emit({"phase": "relayout", "shape": label, "tiles": r["tiles"],
              "piece_len": r["piece_len"], "value": r["value"],
              "predicted_natural_gbps": r["predicted_natural_gbps"], "legs": legs(r),
              "launches": launches,
              "transpose_only_plain_ms": r["transpose_only_plain_ms"],
              "sm_clock_mhz": clock, "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    t_err = max(t_errs)
    if t_err:
        raise AssertionError(f"relayout: transpose_only != plain version (max abs err {t_err})")
    full = decomps["full_card"]
    t_bound = legs(full)["transpose_only"]
    emit({"phase": "relayout", "checks": checks, "max_abs_err": t_err})

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
        {"name": "pack_tiles_device", "route": "cuda",
         "source": "kraken_tpu_torch/csrc/sha256_packed.cu",
         "replaces": "kraken_tpu/ops/sha256_pallas.py:321",
         "launches": ingest_launches["pack_tiles_device"], "max_abs_err": 0,
         "ms": pack_ms, "plain_ms": pack_plain_ms, "bound_ms": pack_bound_ms,
         "bound_by": pack_bound_by, "library_ms": pack_library_ms,
         "shape": "1024 x 4 MiB", "plain_shape": "1024 x 4 MiB"},
        {"name": "sha256_packed_tiles", "route": "cuda",
         "source": "kraken_tpu_torch/csrc/sha256_packed.cu",
         "replaces": "kraken_tpu/ops/sha256_pallas.py:251",
         "launches": ingest_launches["sha256_packed_tiles"], "max_abs_err": 0,
         "ms": packed_ms, "plain_ms": packed_plain_ms, "bound_ms": packed_bound_ms,
         "bound_by": packed_bound_by, "library_ms": None,
         "shape": "1024 x 4 MiB", "plain_shape": "1024 x 16 KiB",
         "ms_at_plain_shape": packed16_ms},
        {"name": "gear_candidates", "route": "cuda", "source": "kraken_tpu_torch/csrc/gear.cu",
         "replaces": "kraken_tpu/ops/cdc_pallas.py:81",
         "launches": dedup_launches["gear_candidates"], "max_abs_err": gear_err,
         "ms": gear_ms, "plain_ms": gear_plain_ms, "bound_ms": gear_bound_ms,
         "bound_by": gear_bound_by, "library_ms": gear_library_ms,
         "shape": "one 64 MiB window", "plain_shape": "one 64 MiB window"},
        # A diagnostic on no path of the system: the main path launches it
        # no time; each decomposition's own launches stand beside.
        {"name": "transpose_only", "route": "cuda", "source": "kraken_tpu_torch/csrc/transpose.cu",
         "replaces": "bench_transpose.py:80", "launches": main_launches["transpose_only"],
         "relayout_launches": relayout_launches, "max_abs_err": t_err,
         "ms": full["transpose_only_ms"], "plain_ms": full["transpose_only_plain_ms"],
         "bound_ms": t_bound["bound_ms"], "bound_by": t_bound["bound_by"], "library_ms": None,
         "shape": f"{FULL_TILES} x 1024 x 64 KiB", "plain_shape": f"{FULL_TILES} x 1024 x 64 KiB",
         "ms_at_bench_shape": decomps["bench_shape"]["transpose_only_ms"]},
    ], "main_path_seconds": main_secs, "ingest_seconds": ingest_secs,
        "dedup_seconds": dedup_secs,
        "int_ops_per_s": card.int_ops_per_s, "sm_clock_hz": card.sm_clock_hz})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
