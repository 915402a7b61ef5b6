#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kraken_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It builds
the port's kernels from ``kraken_tpu_torch/csrc/`` (one ``nvcc`` per
source, all at once, a few seconds) and the host packer
(``kraken_tpu_torch/native/hostpack.c``), then runs twenty phases, each
printing JSON lines; any failure raises and the script exits non-zero
without a result:

1. ``build``   -- the kernel library, the compiler's register report, the
   gear kernel's SASS instruction count and its run body a byte by pipe,
   the SHA-256 kernels' per-block SASS counts by pipe (below), and which
   host packer was built (``c``, or ``numpy`` without a compiler).
2. ``kernels`` -- the SHA-256 kernel of ``csrc/sha256.cu`` against its
   plain PyTorch version and hashlib,
   on the card: lengths 0..257 (16-byte aligned and skewed starts, so all
   three load paths run), 37 x 4 KiB uniform pieces, 300 ragged pieces of
   0-70,000 bytes, one 4 MiB + 13 piece, and the main path's row counts
   (64 uniform rows; 64 ragged rows and a short one) at 16 KiB a row. The
   edges of the block ring: rows of 0-3 full blocks with tails of 0, 55,
   56 and 63 bytes (ragged at three alignments, and 33 uniform rows of
   each length), and rows ending at the last byte of an exact-size
   tensor.
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
   hasher end to end from host memory. Then ``main_shape``: each SHA-256
   wrapper at the main path's launch, 64 x 4 MiB, with its cycles a block
   of the longest row, its chain bound and the share of it.
6. ``packed``  -- the two kernels of ``csrc/sha256_packed.cu`` against
   their plain versions and hashlib: the pack bit for bit at the full
   window (1024 x 4 MiB), 1024 x 576 B and 2048 x 64 B; the packed hash
   at 1024 x 16 KiB, 1024 x 576 B and 1024 pieces of 1, 2 and 8 blocks
   (8 = NB: the tensor's last block) against the plain version, at
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
   PyTorch version on the card, position for position: one 64 MiB window
   with a ragged tail from the blob's offset 0, one with 31 bytes of
   history, a 1 MiB window at mask 0 (every position a candidate) and one
   at ``CDCParams(64, 256, 1024)``; a blob of two windows and a ragged
   tail whose first 31 bytes hash onto the loose mask with zero history
   (the candidate lists of the windowed kernel route against one
   whole-blob plain pass); and a 1 GiB blob, whose cuts through the
   kernel route must equal the sequential C chunker's
   (``native.cdc_chunk_native``), with the window path's stage split
   summed over windows (``cdc_cuda.STAGES``) and the host's cut
   selection. The kernel is timed at the main path's window beside its
   bound, the plain pass and one PyTorch expression (the doubling in int32
   with wraparound, then ``torch.nonzero``); the copy into pinned staging
   is timed at one thread and at ``cdc_cuda.COPY_THREADS``.
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
11. ``swarm``  -- the P2P plane: port ``Scheduler``s, each with its own
   ``CAStore``, on 127.0.0.1 in this process's one asyncio loop, an
   in-memory tracker (``SwarmTracker``), the default ``SchedulerConfig``.
   Every agent's ``BatchedVerifier`` takes the ``cuda`` hasher with a 2 ms
   window, as the reference's agent builds one for an accelerator hasher;
   each seeder's metainfo comes from ``Generator(store)`` on the card, at
   4 MiB pieces, and its piece hashes must equal hashlib's over the
   seeder's bytes. Three legs: (a) BASELINE.json config 2, 10 agents pulling
   two layers sized like ``alpine`` and ``ubuntu:22.04`` (``SWARM_LAYERS``)
   from one origin-style seeder, all at t = 0; (b) one agent pulling a
   1 GiB blob (256 pieces); (c) a seeder serving one piece with a flipped
   byte, the agent's only peer until it rejects that piece on the card and
   blacklists it, then a good seeder. Gates: every blob byte-identical;
   ``sha256_uniform`` launched for the seeders' metainfo; in each leg
   ``sha256_ragged`` launched at least once an agent and layer and at most
   once a verified piece, the rows hashed on the card covering every
   piece the agents needed, no host verify batch, the leg inside its
   timeout (``SWARM_TIMEOUT_S``); in (c) a ban for a digest mismatch. Each
   leg prints its wall, (a) the agents' pull p50 and p99, (b) GB/s, the
   launches, rows a launch, the flush sizes, the summed seconds of the
   ``hash_batch`` calls and the part of the wall some verify ran in.
12. ``tracker`` -- phase 11(a)'s flash crowd (BASELINE.json config 2: the
   same two layers, 4 MiB pieces, 10 agents at t = 0, the seeder's
   metainfo from ``Generator(store)`` on the card) through three port
   ``TrackerServer``s, each served by ``http_lite.serve`` on 127.0.0.1
   (0.5 s announce interval, default handout, ``fleet_addrs`` the three
   addresses, so a non-owner forwards announces to the shard owner). Their
   ``origin_cluster`` (``FleetOrigin``) hands out the card-made metainfo
   and counts its fetches. Every peer's metainfo and announce client is
   ``make_tracker_client(",".join(addrs))``, a ``TrackerFleetClient``, so
   the agents fetch metainfo through the trackers' proxy and its cache.
   The fleet's three ports are picked (``fleet_ports``) so that the
   smaller layer's owner is the tracker the larger layer does not fail
   over to. The tracker that ``rendezvous_hash`` names for the larger
   layer is stopped (its runner's ``cleanup()`` and ``close()``) when the
   first agent holds a piece of that layer, or at 1 s. Gates: every blob
   byte-identical; ``sha256_uniform`` launched for the metainfo and, in
   the pulls, ``sha256_ragged`` at least once an agent and layer and the
   rows on the card covering every needed piece, no host verify batch;
   the kill before the first pull ended; both survivors recording
   announces after it; a fleet client's breaker naming the dead owner
   with its failures (``healthcheck.debug_snapshot()``). It prints the
   wall, pull p50 and p99, the kill's time and the pieces done by then,
   announces per tracker before and after the kill, the fleet clients'
   failover and outage counters, the proxy's metainfo fetches and cache
   hits, the launches, rows a launch, verify's part of the wall, and the
   bytes on the wire against those needed.

13. ``origin_http`` -- the origin over the port's HTTP/1.1: port
   ``OriginServer``s on ``http_lite.serve``, each on a fresh ``CAStore``
   with a ``Generator`` on the ``cuda`` hasher, uploaded to by the port's
   ``BlobClient`` (16 MiB PATCH bodies; ``TimedClient`` marks the stream,
   the commit and any resume). First ``http_lite`` alone (256 MiB of PATCH
   bodies into a sink, a 256 MiB GET), then seven legs: (a) BASELINE.json
   config 1's 1 GiB to an origin with no ingest pipeline and a
   ``DedupIndex`` on the card: the metainfo made at commit in one batched
   pass, the dedup task awaited; (b) the same blob to an origin with
   ``IngestPipeline(cuda, IngestConfig())``: pieces hashed through the
   pipeline's windows while the body streams in; which of (a) and (b)
   acks sooner; (c) 128 MiB to (a)'s origin with ``origin.patch.write``
   armed at the middle flush: the client sees a 500, HEADs the durable
   offset, the origin re-adopts the session from its journal, the client
   re-PATCHes the tail; (d) the 1 GiB back whole, one 206 range and a 416
   past the end; (e) a 128 MiB blob only in a ``file`` backend, pulled by
   a ``Refresher`` on a GET miss, and (a)'s blob written back by
   ``WritebackExecutor``; (f) three origins on one ``Ring``,
   ``write_quorum: 2``, 128 MiB: the 201 only once a replica holds the
   blob, then the owner's ``persistedretry`` queue drains replication to
   the third; (g) a port ``TrackerServer`` whose ``origin_cluster`` is a
   port ``ClusterClient``, and one agent pulling 64 MiB that (a)'s origin
   seeds through its ``scheduler=``, verifying on the card. Gates: every
   blob byte-identical; every metainfo equal to hashlib's piece hashes
   (``GET /metainfo`` to the port's ``MetaInfo`` bytes over them); each
   leg's kernels launched; the failpoint fired once and one session
   re-adopted; a replica held the blob at the quorum's 201 and its
   metainfo equals the owner's; the agent's metainfo through the
   tracker's proxy; no hashlib piece hashing
   (``hasher_pieces_total{hasher="cpu"}``) and no host verify batch in the
   whole phase. Each leg prints its walls, GB/s, launches by wrapper and
   checks.
14. ``herd`` -- the North star's main path as the system runs it: origin,
   tracker and agent as three processes of ``python -m
   kraken_tpu_torch.cli``, each from a config that extends the shipped
   ``config/<component>/base.yaml`` by its relative path and overrides only
   its host, ports (0), store, ``backends: []`` and its peers (flags);
   origin and agent with ``--hasher cuda``. The tracker is started, the
   origin pointed at it, then the tracker respawned on its port with the
   origin's address. The port's ``BlobClient`` uploads BASELINE.json config
   1's 1 GiB (4 MiB pieces, seeded) to the origin, whose ingest pipeline
   hashes the pieces at stream time; a GET of the blob on the agent pulls
   it over the wire, every piece verified on the card, and streams it
   back. Then SIGHUP with a changed ``scheduler.wire_send_batch``, which
   the agent must apply, and SIGTERM to each child, which must drain and
   exit 0 within the shipped ``rpc.drain_timeout_seconds``. Launch counters
   of another process are not visible here, so the gates read the
   children's ``GET /metrics`` (``kernel_launches_total``, the wrappers'
   own counts, beside the hasher and verify counters): the blob
   byte-identical; ``GET /metainfo`` through the tracker equal to the
   port's ``MetaInfo`` over hashlib's piece hashes; the origin's 16 ingest
   windows and ``hasher_pieces_total{hasher="cuda"}`` risen by the 256
   pieces plus its dedup chunks, ``{hasher="cpu"}`` unmoved; the agent's
   every verify batch on the card, at least 1 GiB hashed there; the gear
   kernel launched at the
   origin (its router's calibration, and each 64 MiB window when the card
   won it; the measured rates are printed); this process launching
   nothing.
   A child that dies before READY has its stderr printed and fails the
   phase. It prints each child's time to READY, the upload's stream,
   commit and 201, the pull's wall and GB/s, the verify batches and rows
   a batch, and the drain times.
15. ``front_door`` -- ``docker push`` and ``docker pull`` as users run
   them: tracker, origin, build-index, proxy and agent as five processes
   of ``python -m kraken_tpu_torch.cli``, all started at once on ports
   picked beforehand, each from a config that extends the shipped
   ``config/<component>/base.yaml`` and overrides only its host, ports
   (0), store, ``backends: []`` and the agent's ``registry_port: 0``,
   the addresses as flags; origin and agent with ``--hasher cuda``. The
   image ``library/app:v1``: a config blob, BASELINE.json config 2's two
   layers (``swarm_layers()``) and config 1's 1 GiB as a third, seeded.
   (a) The push through the proxy, with the port's ``http_lite`` client
   doing what ``docker push`` does: per blob HEAD (404), POST (202 and
   ``Location``), 16 MiB PATCH bodies, PUT ``?digest=`` (201), then the
   schema2 manifest by tag; each finalize split by ``UploadWatch`` from
   the origin's store tree into the proxy's hashlib digest of its spool,
   its upload to the origin and the origin's commit. (b) The pull by tag
   through the agent's registry: the manifest with docker's three Accept
   lines (byte-identical), each blob by digest (its SHA-256 = its
   digest; the wall split at the response head into the swarm pull and
   the serve), a HEAD of the 1 GiB layer, a ``Range: bytes=<mid>-`` GET
   (206, exactly the slice), ``tags/list``; then a second pull of the
   tag, served from the agent's cache. (c) A POST to the agent's
   registry answers ``UNSUPPORTED``; every answer carries
   ``Docker-Distribution-API-Version: registry/2.0``. (d) SIGTERM to each
   child: exit 0 within its ``rpc.drain_timeout_seconds``. Gates from the
   children's ``/metrics`` and the build-index: the origin's
   ``hasher_pieces_total{hasher="cuda"}`` risen by every pushed blob's
   pieces plus its dedup chunks, ``{hasher="cpu"}`` unmoved, one ingest
   window a 64 MiB; ``sha256_uniform``, ``sha256_ragged`` and
   ``gear_candidates`` launched at the origin; every agent verify batch
   on the card, at least the image's bytes hashed there; the second pull
   launching nothing; the build-index's tag equal to the manifest's
   digest; this process launching nothing.
16. ``delta`` -- a rebuilt layer pulled by delta over the chunk tier:
   tracker, origin and agent A with ``delta`` and ``chunkstore`` on, and
   agent B with the shipped values (both off) as the control, four CLI
   processes started together, ``--hasher cuda``. Two consecutive builds
   of ~1 GiB by the reference's ``_make_build_pair`` (1024 files of 1 MiB
   behind 64 B unique headers, ``reuse=0.8``, seeded): both uploaded; the
   origin's dedup pass and chunk conversion awaited, each build then
   chunk-backed with no flat file; A pulls build 1 (seeded by the
   chunk-backed origin) then build 2, B build 2. Gates: every pull
   byte-identical with its SHA-256 = its digest; A's build-2 moved bytes
   (``p2p_piece_bytes_down_total`` + ``delta_bytes_fetched_total``) at
   most ``DELTA_BAND_MAX`` of B's, with local copies; no host verify
   batch in A or B and no hashlib piece at the origin; ``sha256_uniform``,
   ``sha256_ragged`` and ``gear_candidates`` launched at the origin and
   ``sha256_ragged`` at each agent. Each pull's wall is split at the
   response head, the prefill by ``delta_stage_seconds_total{stage}``
   (plan, copy, recheck, fetch, write), the rest being the swarm; each
   tier's stored and logical bytes; a SIGHUP turning A's delta off, read
   on its log; SIGTERM drains.
17. ``operator`` -- the operator's plane on phase 14's herd: tracker,
   origin and agent as three CLI processes started together, ``--hasher
   cuda``, the agent's canary probing the origin every 2 s (the shipped
   256 KiB blob), its shipped observe-only ``resources:`` and a 1 s SLO
   evaluation. (a) The canary alone: three probes recorded good
   (``slo_events_total{canary="1",result="good"}``), each launching
   kernels at the origin and the agent; each probe's pull latency from
   its document on ``/debug/slo``. (b) 1 GiB uploaded and pulled through
   the agent, byte-identical with its SHA-256 = its digest, while the
   agent's ``/debug/torch-profile`` captures 10 s of it: the trace must
   name ``sha256_rows_kernel``, no more times than the wrappers counted
   launches across the capture; the kernel's summed time over the
   capture's wall is the card's busy share during a pull; a second
   capture meanwhile answers 409; the canary probes that ran during the
   pull, with their latency. (c) Every node's ``/debug/`` lists the
   mux's routes (``torch-profile``, no ``jax-profile``); ``/debug/slo``,
   ``/debug/resources`` and the breakers of ``/debug/healthcheck`` have
   the reference's keys; ``http_requests_total`` has the agent's blob
   route under its template and no label holds a 64-hex digest. (d)
   ``status`` over the three exits 0; ``trace`` over the three nodes'
   spans of the last probe (``/debug/trace?view=trace``) joins them and
   exits 0; ``flame`` over the agent's ``/debug/pprof/profile`` exits 0
   with a verify plane. (e) SIGTERM: the agent exits 0 having reaped
   every canary blob from the origin and its state file; then the
   origin, and ``status`` over tracker and origin exits 2 naming the
   origin alone; then the tracker.
18. ``shards`` -- pulls through forked workers beside a live CUDA context:
   tracker, an origin with ``data_plane_workers: 2``, agent A with two
   seed-serve and two leech workers, agent B at 0 holding one conn a
   torrent, four CLI processes. (a) 1 GiB pulled by A through its leech
   workers; (b) A and B pull a fresh 1 GiB, B from A, A's leech worker
   SIGKILLed at a quarter of the pieces and respawned; (d) the origin
   SIGHUPed from two workers to one at half; (c) B pulls (a)'s blob from
   A's seed workers; (e) SIGTERM, every child 0, no worker left.
19. ``backends`` -- an origin in front of blob storage, as kraken is
   deployed: tracker, origin, build-index and agent (with its registry
   endpoint) as four CLI processes started together, ``--hasher cuda``;
   the origin's ``backends:`` maps ``^s3/.*`` to ``s3`` at a fake S3 and
   ``^library/.*`` to ``registry_blob`` at a fake upstream registry, the
   build-index's ``.*`` to ``registry_tag`` there (``RemoteFakes``: both
   in this process on ``http_lite``; S3 re-derives every SigV4 signature
   with the port's ``sigv4_headers``, the upstream speaks the docker
   token flow and 307s blob GETs to a presigned listener that refuses an
   ``Authorization`` header). (a) 1 GiB uploaded under ``s3/``, written
   back by the origin's retry plane through S3's multipart upload: 16
   parts of 64 MiB, one initiate, one complete, no abort, the object's
   SHA-256 its digest, the wall from the 201 to the complete. (b) A fresh
   1 GiB put straight into S3 under the pather's key; the agent GETs it
   by digest, the origin refreshes on the miss (one GET of the object),
   makes its metainfo on the card and seeds it: byte-identical, the
   metainfo through the tracker equal to hashlib's, the wall split into
   the origin's refresh (its metainfo request, from ``/metrics``; the
   fake's S3 GET), the swarm and the serve. (c) ``library/ubuntu:22.04``
   (a config blob and a layer at BASELINE.json config 2's ``ubuntu``
   size) only upstream, pulled by tag through the agent's registry: the
   tag through ``registry_tag``, the blobs through ``registry_blob``;
   byte-identical, one token fetch a process holding an upstream client,
   no ``Authorization`` on the presigned hop, the second pull launching
   nothing. (e) SIGTERM, every child 0. (d) The offline tools on the
   stopped nodes' stores: ``scrub`` of the agent's store 0 with
   ``checked`` its blobs, 1 naming the digest of one flipped byte, 2 for
   a missing root; ``fsck`` of the origin's store 0; ``locate`` naming the
   origin; ``lint kraken_tpu_torch/`` 0; a ``testfs`` process READY,
   alive after SIGHUP, 0 on SIGTERM. In (b) and (c) every origin piece
   and every agent verify on the card, ``sha256_uniform`` launched at the
   origin and ``sha256_ragged`` at the agent.
20. ``parallel`` -- the sharded hash plane on the card's default mesh
   (every visible card; one here, so no speed-up across cards is
   claimed). (a) ``ShardedPieceHasher()`` and ``TorchPieceHasher()`` on
   one 1 GiB + 12,345 B blob of 4 MiB pieces, in turns: both equal to
   hashlib, the sharded call launching ``sha256_uniform`` once a mesh
   device and ``sha256_ragged`` once for the tail; each call's wall.
   (b) ``IngestPipeline(get_hasher("cuda-sharded"), IngestConfig())`` on
   the blob's first 1 GiB: 16 windows of 64 MiB, each staged on the mesh
   and hashed, equal to hashlib; the ``transfer`` and ``hash`` walls.
   (c) Four processes of ``python -m kraken_tpu_torch.parallel.multihost
   p 4 <port> --platform cuda``, each hashing its own batch of 4 MiB
   pieces on the card and gathering the digests over gloo: every rank's
   global matrix equal to hashlib over all four batches, every rank 0;
   each rank's launches and the gather's wall. (d) A ``--hasher
   cuda-sharded`` origin of the CLI: READY, 1 GiB uploaded, ``GET
   /metainfo`` equal to hashlib's, its 16 windows staged and hashed on the
   card (``kernel_launches_total``, ``ingest_windows_total`` and
   ``hasher_pieces_total{hasher="cuda-sharded"}`` from its ``/metrics``),
   none by hashlib, SIGTERM 0.

Phases 8 and 10 read the SM clock right after their timed launches.

The launch counters are zeroed just before each main path (origin +
agent; each ingest run; the dedup indexing; each decomposition; each
swarm leg and the tracker phase's pulls, and each seeder's metainfo; each
leg of phase 13; phase 14's to 19's children, through their
``/metrics``; each leg of phase 20, its ranks and its origin by their own
counts) and
read just after it: every
wrapper must have launched on its path. Then the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.

The bound of a launch is the larger of its bytes over the card's memory
rate (each input read once, each output written once) and its work over
the card's rate for it. The pack moves bytes. The gear pass's work a byte
is ``GEAR_WORK``, by pipe as below, with every SM full, against the window
read once and the codes written. A SHA-256 kernel's work is
what the function needs a block (``SHA_ROUNDS``, ``SHA_SCHEDULE``,
``SHA_BSWAP``), each operation in its least Hopper form and by the pipes
it can issue to: rotates, shifts and logic only to the integer ALU pipe,
adds to it or to the FMA pipe. Its throughput bound puts every SM at its
two pipes' lanes and issue slots; its chain bound runs the longest row's
64 rounds a block one after another at one warp's issue (the schedule can
run on another warp), each ALU instruction holding its 16-lane pipe 2
clocks. The bound is the largest of the two and the byte bound: the chain
at the main path's 64-row launches, the throughput with the card full.
The build phase prints each SHA-256 kernel's per-block loop and the gear
kernel's run body a byte as built, by pipe (``cuobjdump -sass``), beside
the bound: how far the build is from the function's work.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import hashlib
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from urllib.parse import quote

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
PIECE = 4 * MiB
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# Hopper's issue model, for the SHA-256 bounds. NVIDIA's CUDA
# C++ Programming Guide ("Arithmetic Instructions", compute capability
# 9.0) gives 64 results a clock an SM for 32-bit integer add, shift,
# compare and bitwise operations, and 64 for 32-bit integer multiply-add;
# the Hopper white paper splits an SM into 4 sub-partitions, each issuing
# one warp instruction a clock, with 16 INT32 lanes (the ALU pipe) and 32
# FP32 lanes, 16 of which also run IMAD (the FMA pipe). So a warp
# instruction holds its pipe for 32 / 16 = 2 clocks and a sub-partition
# issues at most one a clock.
WARP = 32
ALU_LANES_PER_SM = 64
FMA_LANES_PER_SM = 64
DISPATCH_PER_SM = 4  # warp instructions issued a clock, one per sub-partition
# Shared memory answers 32 four-byte banks a clock an SM: one conflict-free
# warp-wide 32-bit load (the CUDA C++ Programming Guide, "Shared Memory",
# compute capability 9.0).
LDS_LANES_PER_SM = 32
SUBPARTITIONS = 4
ALU_OPCODES = frozenset((
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP",
    "ICMP", "SEL", "LEA", "MOV", "IABS", "IMNMX", "VIADD", "VIMNMX", "VIMNMX3", "BMSK",
    "SGXT", "PLOP3", "P2R", "R2P",
))
FMA_OPCODES = frozenset(("IMAD", "IMUL", "FFMA", "FMUL", "FADD"))
# The schedule and the rounds are unrolled, so a per-block loop holds at
# least 48 schedule steps or 64 rounds of several instructions each.
MIN_BLOCK_LOOP = 256
ROWS_KERNEL, PACKED_KERNEL = "sha256_rows_kernel", "sha256_packed_kernel"
# SHA-256's work a 64-byte block (FIPS 180-4), each operation once in its
# least Hopper form: a rotate or shift is one funnel shift (SHF), a logic
# function of up to three inputs one LOP3, an add of up to three terms one
# IADD3. Rotates, shifts and logic issue only to the ALU pipe ("alu"); an
# add issues to the ALU pipe or, as IMAD, to the FMA pipe ("either",
# counted as IADD3s: the FMA form adds two terms, so this undercounts, and
# the bound stays a bound). A round: Sigma1 and Sigma0 (3 rotates and a
# three-input xor each), Ch and Maj (a LOP3 each); T1 = h + Sigma1 + Ch +
# K + W (two adds), e = d + T1, a = T1 + Sigma0 + Maj; then the state's 8
# adds. A schedule step: sigma0 and sigma1 (2 rotates, a shift and a xor
# each), W = sigma1 + W[t-7] + sigma0 + W[t-16] (two adds). A natural row's
# 16 words are byte-swapped (a PRMT each); a packed tile's are big-endian.
SHA_ROUNDS = {"alu": 64 * (6 + 4), "either": 64 * 4 + 8}
SHA_SCHEDULE = {"alu": 48 * (6 + 2), "either": 48 * 2}
SHA_BSWAP = {"alu": 16, "either": 0}
SHA_BLOCK = {
    ROWS_KERNEL: {k: SHA_ROUNDS[k] + SHA_SCHEDULE[k] + SHA_BSWAP[k] for k in SHA_ROUNDS},
    PACKED_KERNEL: {k: SHA_ROUNDS[k] + SHA_SCHEDULE[k] for k in SHA_ROUNDS},
}
TAIL = 12_345
# The relayout decomposition's full-card shape: 132 tiles of 1024 pieces,
# 1,024 pieces an SM, chip_sha256_sweep.py's top point.
FULL_TILES = 132
# The gear pass's work a byte, each operation once in its least Hopper form
# and by the pipes it can issue to, as for SHA-256. The gear map is a
# lookup in a shared-memory table of its 256 values with a copy in every
# bank: the byte's extraction (PRMT) on the ALU pipe, its table address
# (LEA or IMAD) on either, the load on the shared-memory pipe ("lds"). The
# rolling form's shift-add (h << 1) + g on either. The mask tests: nested
# top-bit masks let h hit either mask only if h <= ~mask_loose, so an
# unsigned min over a run serves both, a 3-input min (VIMNMX3) a half on
# the ALU pipe. (The map computed arithmetically -- two shifts and two xors
# only on the ALU pipe, two multiplies only on the FMA pipe -- costs more:
# tests/test_torch_sass.py.)
GEAR_WORK = {"alu": 1.5, "either": 2, "lds": 1}
GEAR_KERNEL = "gear_candidates_kernel"
GEAR_RUN = 32  # positions a lane's run: a warp instruction of the run's body a 1 KiB step
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


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_function(sass: str, kernel: str) -> list[tuple[int, str]]:
    """(address, instruction) of each instruction of one kernel's function
    in a ``cuobjdump -sass`` listing."""
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and (m := _SASS_LINE.match(line)):
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def sass_instructions(sass: str, kernel: str) -> int:
    """Instructions of one kernel's function in a ``cuobjdump -sass``
    listing."""
    return len(sass_function(sass, kernel))


def sass_loops(ins: list[tuple[int, str]]) -> list[list[str]]:
    """Each loop of a function: a backward branch and every instruction from
    its target to it."""
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b.*0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            start = int(m.group(1), 16)
            loops.append([t for a, t in ins if start <= a <= addr])
    return loops


def opcode(instruction: str) -> str:
    """An instruction's opcode with its modifiers (a predicate is dropped)."""
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def block_loop(sass: str, kernel: str, min_len: int = MIN_BLOCK_LOOP) -> list[str]:
    """The instructions of a SHA-256 kernel's per-block loop on the main
    path: its one loop of at least ``min_len`` instructions that copies
    blocks through the shared-memory ring (``LDGSTS``)."""
    loops = [lp for lp in sass_loops(sass_function(sass, kernel))
             if len(lp) >= min_len and any(opcode(i).startswith("LDGSTS") for i in lp)]
    if len(loops) != 1:
        raise ValueError(f"{kernel}'s SASS has {len(loops)} ring loops of {min_len}+ "
                         "instructions, not 1")
    return loops[0]


def pipe_of(instruction: str) -> str:
    """``alu``, ``fma`` or ``other``: the pipe an instruction issues to
    (opcode before its first dot)."""
    base = opcode(instruction).split(".")[0]
    return "alu" if base in ALU_OPCODES else "fma" if base in FMA_OPCODES else "other"


def pipe_counts(instructions: list[str]) -> dict[str, int]:
    counts = {"alu": 0, "fma": 0, "other": 0}
    for ins in instructions:
        counts[pipe_of(ins)] += 1
    return counts


def chain_cycles(work: dict[str, int]) -> int:
    """Least clocks one warp alone on its sub-partition takes for this
    work: each ALU-only instruction holds the ALU pipe 2 clocks, the adds
    fill the FMA pipe beside it (the two pipes have equal lanes), and
    every instruction takes one of the warp's issue slots, one a clock."""
    hold = WARP * SUBPARTITIONS // ALU_LANES_PER_SM
    return max(hold * work["alu"], work["alu"] + work["either"])


def throughput_cycles(work: dict[str, float]) -> float:
    """Least SM clocks this work costs when the SM is full: the ALU-only
    operations over the ALU pipe's lanes, the FMA-only ones (``fma``, none
    if absent) over the FMA pipe's, the arithmetic over both pipes' lanes,
    shared-memory loads (``lds``, none if absent) over the banks, and all
    of them over the SM's issue slots."""
    fma, lds = work.get("fma", 0), work.get("lds", 0)
    arith = work["alu"] + fma + work["either"]
    return max(work["alu"] / ALU_LANES_PER_SM, fma / FMA_LANES_PER_SM,
               arith / (ALU_LANES_PER_SM + FMA_LANES_PER_SM), lds / LDS_LANES_PER_SM,
               (arith + lds) / (DISPATCH_PER_SM * WARP))


def gear_bounds(positions: int, nbytes: float, sms: int, clock_hz: float) -> dict:
    """Least time (ms) for the gear pass over ``positions`` bytes with
    ``nbytes`` moved: the larger of ``GEAR_WORK`` a byte with every SM
    full and the bytes over the memory rate (the bytes, at any size)."""
    ops = positions * throughput_cycles(GEAR_WORK) / sms / clock_hz * 1e3
    byt = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops, byt), "bound_by": "bytes" if byt >= ops else "operations",
            "ops_bound_ms": ops, "bytes_bound_ms": byt}


def sha_bounds(kernel: str, blocks: int, longest: int, nbytes: float, sms: int,
               clock_hz: float) -> dict:
    """Least time (ms) for ``kernel`` to hash ``blocks`` SHA-256 blocks,
    ``longest`` of them in one row's chain, over ``nbytes`` moved: the
    larger of the throughput bound (every SM at the pipe limits of a
    block's work), the chain bound (the longest row's rounds one block
    after another at one warp's issue; the schedule's own chain is
    shorter) and the byte bound."""
    thr = blocks * throughput_cycles(SHA_BLOCK[kernel]) / sms / clock_hz * 1e3
    chain = longest * chain_cycles(SHA_ROUNDS) / clock_hz * 1e3
    byt = nbytes / HBM_BYTES_PER_S * 1e3
    ms = max(thr, chain, byt)
    return {"bound_ms": ms, "bound_by": "bytes" if byt >= max(thr, chain) else "operations",
            "throughput_bound_ms": thr, "chain_bound_ms": chain, "bytes_bound_ms": byt}


def rows_work(lengths) -> tuple[int, int, int]:
    """(blocks, blocks of the longest row, bytes moved) of hashing rows of
    these lengths: rows, offsets, lengths and digests."""
    blocks = [nblocks(n) for n in lengths]
    return sum(blocks), max(blocks), sum(lengths) + len(lengths) * (8 + 8 + 32)


def packed_work(pieces: int, nb: int) -> tuple[int, int, int]:
    """(blocks, blocks of a piece, bytes moved) of hashing ``pieces`` packed
    pieces of ``nb`` blocks: the data blocks and a padding block each, the
    data read and the digests written."""
    return pieces * (nb + 1), nb + 1, pieces * nb * 64 + pieces * 32


_BRANCH = re.compile(r"\bBRA\b.*0x([0-9a-f]+)")


def gear_run_body(sass: str, kernel: str = GEAR_KERNEL) -> list[str]:
    """The instructions a warp issues for one run of ``GEAR_RUN`` positions a
    lane on the common path: the kernel's first loop (lowest start) that
    loads 16 bytes a lane (``LDG...128``), less the rare path inside it --
    the code that a forward branch to a target inside the loop skips and
    that holds the atomic."""
    ins = sass_function(sass, kernel)
    loops = []
    for addr, text in ins:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            body = [(a, t) for a, t in ins if int(m.group(1), 16) <= a <= addr]
            if any(opcode(t).startswith("LDG") and ".128" in opcode(t) for _, t in body):
                loops.append(body)
    if not loops:
        raise ValueError(f"{kernel}'s SASS has no loop of 16-byte loads")
    body = min(loops, key=lambda lp: lp[0][0])
    for addr, text in body:
        m = _BRANCH.search(text)
        if m and addr < int(m.group(1), 16) <= body[-1][0]:
            target = int(m.group(1), 16)
            if any(addr < a < target and opcode(t).startswith(("ATOM", "RED"))
                   for a, t in body):
                body = [(a, t) for a, t in body if not addr < a < target]
                break
    return [t for _, t in body]


def gear_sass_per_byte(sass: str) -> dict[str, float]:
    """The gear kernel's run body as built, by pipe, a byte: warp
    instructions a 1 KiB step, each lane's ``GEAR_RUN`` positions."""
    return {k: v / GEAR_RUN for k, v in pipe_counts(gear_run_body(sass)).items()}


# Clocks the card spins before a queued timing (~2 ms at 1.98 GHz): longer
# than the host takes to enqueue the timed calls.
SPIN_CYCLES = 4_000_000


def queued_ms(fn, reps: int = 10) -> float:
    """Device time (ms) a call of ``fn``, over ``reps`` calls enqueued behind
    a spin of the card, so that a short launch is timed without the host's
    time to issue it (which ``cuda_ms`` counts when the card is idle)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    """The card's peaks, read from the card itself, and the SHA-256
    kernels' per-block SASS counts, read from the built library."""

    def __init__(self):
        self.name_power = smi("name,power.limit")
        self.sm_clock_hz = float(smi("clocks.max.sm", "nounits")) * 1e6
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.int_ops_per_s = self.sms * ALU_LANES_PER_SM * self.sm_clock_hz
        self._sass = None

    @property
    def sass(self) -> str:
        """``cuobjdump -sass`` of the port's kernel library (built if not
        yet)."""
        if self._sass is None:
            from kraken_tpu_torch.ops import cuda_lib
            cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            self._sass = subprocess.run([cuobjdump, "-sass", str(cuda_lib.build())],
                                        capture_output=True, text=True, check=True).stdout
        return self._sass

    def sass_per_block(self, kernel: str) -> dict[str, int]:
        """``kernel``'s per-block loop as built, by pipe."""
        return pipe_counts(block_loop(self.sass, kernel))

    def sha_bound(self, kernel: str, blocks: int, longest: int, nbytes: float) -> dict:
        return sha_bounds(kernel, blocks, longest, nbytes, self.sms, self.sm_clock_hz)

    def bound(self, lengths) -> tuple[float, str]:
        """Least time (ms) the card could take to hash rows of these
        lengths with ``sha256_rows_kernel``, and what bounds it."""
        b = self.sha_bound(ROWS_KERNEL, *rows_work(lengths))
        return b["bound_ms"], b["bound_by"]

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


# -- phase 11, the swarm ----------------------------------------------------
# Two layers sized like the compressed amd64 layers of ``alpine`` (about
# 3.4 MB) and ``ubuntu:22.04`` (about 29.5 MB) on Docker Hub: BASELINE.json
# config 2's multi-layer pull. The exact counts are this script's own; the
# bytes come from numpy, seeded. At 4 MiB pieces: 1 + 8 pieces.
SWARM_LAYERS = (("alpine", 3_418_017), ("ubuntu", 29_535_503))
SWARM_AGENTS = 10
SWARM_NS = "library"
SWARM_TRACKER_INTERVAL = 0.5  # seconds the in-memory tracker hands out
SWARM_PAIR_BYTES = GiB  # BASELINE.json config 1's blob: 256 pieces
SWARM_CORRUPT_BYTES = 16 * PIECE  # one pipeline of requests (16)
SWARM_CORRUPT_PIECE = 5
SWARM_TIMEOUT_S = {"flash_crowd": 180.0, "pair": 300.0, "corrupt": 120.0}


class SwarmTracker:
    """In-memory announce and metainfo service shared by the peers of a
    leg, on the model of ``tests/test_swarm.py``'s ``FakeTracker``: phase
    11's baseline with no HTTP in the way, beside phase 12, where the same
    peers announce to the port's own tracker fleet
    (``kraken_tpu_torch.tracker``)."""

    def __init__(self, interval: float):
        self.interval = interval
        self.metainfos: dict = {}
        self.peers: dict[str, dict] = {}

    def client(self, ref: dict):
        from kraken_tpu_torch.core.peer import PeerInfo

        tracker = self

        class Client:
            async def get(self, namespace, d):
                return tracker.metainfos[d.hex]

            async def announce(self, d, h, namespace, complete):
                me = ref["s"]
                swarm = tracker.peers.setdefault(h.hex, {})
                swarm[me.peer_id.hex] = PeerInfo(me.peer_id, me.ip, me.port,
                                                 complete=complete)
                return ([p for k, p in swarm.items() if k != me.peer_id.hex],
                        tracker.interval)

        return Client()


class HashBatchTimer:
    """Stands in for a hasher's ``hash_batch``: each call's rows and its
    start and end on the host clock (calls run on worker threads), and how
    many calls are running."""

    def __init__(self, hasher):
        self._inner = hasher.hash_batch
        self._lock = threading.Lock()
        self.calls: list[tuple[float, float, int]] = []
        self.running = 0
        hasher.hash_batch = self

    @classmethod
    def of(cls, hasher) -> "HashBatchTimer":
        """The hasher's timer: the one already in place, or a new one."""
        timer = hasher.hash_batch
        return timer if isinstance(timer, cls) else cls(hasher)

    def __call__(self, pieces):
        with self._lock:
            self.running += 1
        t0 = time.perf_counter()
        try:
            return self._inner(pieces)
        finally:
            with self._lock:
                self.calls.append((t0, time.perf_counter(), len(pieces)))
                self.running -= 1

    async def settled(self, quiet: float = 0.05) -> None:
        """Return once no call has run or started for ``quiet`` seconds:
        late duplicates of a finished pull may still be in a flush."""
        seen = -1
        while True:
            with self._lock:
                state = (self.running, len(self.calls))
            if state[0] == 0 and state[1] == seen:
                return
            seen = state[1]
            await asyncio.sleep(quiet)

    def take(self) -> list[tuple[float, float, int]]:
        with self._lock:
            calls, self.calls = self.calls, []
        return calls


def covered_seconds(spans) -> float:
    """Seconds covered by at least one of the (start, end) spans."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class SwarmCounters:
    """The launch counters and the verify plane's metrics over one leg:
    zeroed (or read) just before it, read just after it and the flushes
    it left running."""

    def __init__(self, timer: HashBatchTimer):
        from kraken_tpu_torch.ops import sha256_cuda
        from kraken_tpu_torch.utils.metrics import REGISTRY

        self._sha, self._reg, self._timer = sha256_cuda, REGISTRY, timer

    def _metrics(self) -> dict:
        c = self._reg.counter
        return {
            "verify_host": c("verify_batches_total").value(path="host"),
            "verify_flushes": c("verify_batches_total").value(path="cuda"),
            "verified_pieces": c("verify_pieces_total").value(),
            "rows_hashed": c("hasher_pieces_total").value(hasher="cuda"),
            "bytes_hashed": c("hasher_bytes_total").value(hasher="cuda"),
            "bytes_down": c("p2p_piece_bytes_down_total").value(),
            "size_observations": self._reg.histogram("verify_batch_size").count(),
        }

    def start(self) -> None:
        self._timer.take()
        self._before = self._metrics()
        self._sha.reset_launches()
        self._t0 = time.perf_counter()

    async def stop(self) -> dict:
        """The leg's wall ends now; its counts are read once the verify
        flushes still running have ended."""
        wall = time.perf_counter() - self._t0
        await self._timer.settled()
        launches = dict(self._sha.LAUNCHES)
        after = self._metrics()
        d = {k: after[k] - self._before[k] for k in after}
        calls = self._timer.take()
        sizes: dict[int, int] = {}
        for _a, _b, n in calls:
            sizes[n] = sizes.get(n, 0) + 1
        end = self._t0 + wall  # verify time within the leg's wall
        busy = covered_seconds((a, min(b, end)) for a, b, _n in calls if a < end)
        ragged = launches["sha256_ragged"]
        return {
            "wall_s": wall, "launches": launches,
            "verify_flushes": d["verify_flushes"], "verified_pieces": d["verified_pieces"],
            "rows_hashed": d["rows_hashed"], "bytes_hashed": d["bytes_hashed"],
            "bytes_down": d["bytes_down"],
            "rows_per_launch": d["rows_hashed"] / ragged if ragged else None,
            "flush_sizes": {str(k): v for k, v in sorted(sizes.items())},
            "verify_batch_size_observations": d["size_observations"],
            "hash_batch_calls": len(calls),
            "hash_batch_s": sum(b - a for a, b, _n in calls),
            "verify_busy_s": busy, "verify_share_of_wall": busy / wall,
            "verify_batches_host": d["verify_host"],
        }


def store_with(root: str, name: str, blobs: dict, lie: bool = False):
    """A fresh ``CAStore`` holding ``blobs`` (digest -> bytes) committed;
    ``lie``: without checking the bytes against their digest."""
    from kraken_tpu_torch import CAStore

    store = CAStore(os.path.join(root, name))
    for d, data in blobs.items():
        uid = store.create_upload()
        store.write_upload_chunk(uid, 0, data)
        store.commit_upload(uid, d, verify=not lie)
    return store


def free_ports(n: int) -> list[int]:
    """``n`` distinct free loopback ports (bound together, then released)."""
    socks = []
    try:
        for _ in range(n):
            sk = socket.socket()
            sk.bind(("127.0.0.1", 0))
            socks.append(sk)
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def hashlib_pieces(data, piece: int) -> bytes:
    """hashlib's piece hashes, on every core: the reference the card's are
    held against (not through a hasher, so no hasher counter moves)."""
    view = memoryview(data)
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return b"".join(ex.map(lambda o: hashlib.sha256(view[o:o + piece]).digest(),
                               range(0, len(view), piece)))


def card_metainfo(store, blobs: dict) -> tuple[list, dict]:
    """The seeder's metainfo through ``Generator(store)`` on the card, its
    piece hashes held against hashlib over the seeder's bytes, so the
    agents' verify answers to a reference the kernel does not share.
    Returns the metainfos and the launches their generation made, counted
    from zero."""
    from kraken_tpu_torch import Generator
    from kraken_tpu_torch.ops import sha256_cuda

    sha256_cuda.reset_launches()
    gen = Generator(store)
    mis = [gen.generate_sync(d) for d in blobs]
    launches = dict(sha256_cuda.LAUNCHES)
    if not launches["sha256_uniform"]:
        raise AssertionError("swarm: the seeder's metainfo skipped sha256_uniform")
    for mi in mis:
        if mi.piece_length != PIECE:
            raise AssertionError(f"swarm: piece length {mi.piece_length}")
        if mi.piece_hashes != hashlib_pieces(blobs[mi.digest], PIECE):
            raise AssertionError(f"swarm: metainfo of {mi.digest.hex[:12]} != hashlib")
    return mis, launches


def swarm_layers() -> dict:
    """BASELINE.json config 2's two layers (``SWARM_LAYERS``), seeded."""
    from kraken_tpu_torch import Digest

    layers = {}
    for i, (_name, size) in enumerate(SWARM_LAYERS):
        data = np.random.default_rng(SEED + 20 + i).bytes(size)
        layers[Digest.from_bytes(data)] = data
    return layers


def check_swarm_leg(leg: str, r: dict, agents: int, layers: int, pieces: int) -> None:
    """The gates of a leg: ``pieces`` is what its agents needed in all."""
    ragged = r["launches"]["sha256_ragged"]
    if ragged < agents * layers:
        raise AssertionError(f"swarm {leg}: {ragged} ragged launches for {agents} "
                             f"agents x {layers} layers")
    if ragged > r["verified_pieces"]:
        raise AssertionError(f"swarm {leg}: {ragged} ragged launches for "
                             f"{r['verified_pieces']} verified pieces")
    # Every piece a torrent took passed verify; with no host verify, on the
    # card. (Late duplicates may still be in a flush when the leg ends.)
    if r["rows_hashed"] < pieces:
        raise AssertionError(f"swarm {leg}: {r['rows_hashed']} rows on the card for "
                             f"{pieces} needed pieces")
    if r["verify_batches_host"]:
        raise AssertionError(f"swarm {leg}: {r['verify_batches_host']} host verify batches")


async def swarm_legs(root: str, card_name_power: str) -> dict:
    """Phase 11: port schedulers pull over loopback in this process's one
    loop, every agent verifying on the card. Returns each leg's result."""
    from kraken_tpu_torch import (
        AgentTorrentArchive, BatchedVerifier, CAStore, Digest, OriginTorrentArchive,
        get_hasher,
    )
    from kraken_tpu_torch.core.peer import PeerID
    from kraken_tpu_torch.p2p.networkevent import Producer
    from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig

    hasher = get_hasher("cuda")  # what every agent's verifier takes
    counters = SwarmCounters(HashBatchTimer.of(hasher))
    results = {}

    def peer(tracker, store, archive_cls, events=None):
        ref: dict = {}
        client = tracker.client(ref)
        # The agent's verifier as the reference's agent builds one for an
        # accelerator hasher: a 2 ms window, so arrivals coalesce.
        verifier = BatchedVerifier(hasher=hasher, max_delay_seconds=0.002)
        s = Scheduler(PeerID(os.urandom(20).hex()), "127.0.0.1", 0,
                      archive_cls(store, verifier), client, client,
                      config=SchedulerConfig(), events=events)
        ref["s"] = s
        return s

    def metainfo(tracker, store, blobs: dict) -> tuple[list, dict]:
        mis, launches = card_metainfo(store, blobs)
        for mi in mis:
            tracker.metainfos[mi.digest.hex] = mi
        return mis, launches

    async def run(leg, scheds, coro):
        for s in scheds:
            await s.start()
        try:
            return await asyncio.wait_for(coro, SWARM_TIMEOUT_S[leg])
        finally:
            for s in scheds:
                await s.stop()

    def identical(store, d, data, what):
        if store.read_cache_file(d) != data:
            raise AssertionError(f"swarm {what}: blob is not byte-identical")

    # (a) Flash crowd: one origin-style seeder, 10 agents, both layers at t = 0.
    tracker = SwarmTracker(SWARM_TRACKER_INTERVAL)
    layers = swarm_layers()
    ostore = store_with(root, "origin", layers)
    mis, gen_launches = metainfo(tracker, ostore, layers)
    seeder = peer(tracker, ostore, OriginTorrentArchive)
    agents = []
    for i in range(SWARM_AGENTS):
        store = CAStore(os.path.join(root, f"agent{i}"))
        agents.append((peer(tracker, store, AgentTorrentArchive), store))

    async def flash_crowd():
        for mi in mis:
            seeder.seed(mi, SWARM_NS)

        async def pull(agent):
            t0 = time.perf_counter()
            await asyncio.gather(*(agent.download(SWARM_NS, d) for d in layers))
            return time.perf_counter() - t0

        counters.start()
        secs = await asyncio.gather(*(pull(a) for a, _st in agents))
        return secs, await counters.stop()

    secs, r = await run("flash_crowd", [seeder] + [a for a, _st in agents], flash_crowd())
    for _a, store in agents:
        for d, data in layers.items():
            identical(store, d, data, "flash crowd")
    pieces = SWARM_AGENTS * sum(mi.num_pieces for mi in mis)
    check_swarm_leg("flash crowd", r, SWARM_AGENTS, len(layers), pieces)
    r.update({"pull_s_p50": float(np.percentile(secs, 50)),
              "pull_s_p99": float(np.percentile(secs, 99)), "pull_s": secs,
              "needed_pieces": pieces, "metainfo_launches": gen_launches})
    results["flash_crowd"] = r
    emit({"phase": "swarm", "leg": "flash_crowd",
          "config": "BASELINE.json config 2: alpine + ubuntu multi-layer pull, "
                    f"{SWARM_AGENTS} peers, default scheduler",
          "layers": {n: s for n, s in SWARM_LAYERS},
          "pieces": [mi.num_pieces for mi in mis], "piece_length": PIECE,
          "timeout_s": SWARM_TIMEOUT_S["flash_crowd"], "card": card_name_power, **r})
    del layers, agents
    shutil.rmtree(root, ignore_errors=True)

    # (b) Pair pull at config 1's size: one agent, 1 GiB, 256 pieces.
    tracker = SwarmTracker(SWARM_TRACKER_INTERVAL)
    data = np.random.default_rng(SEED + 30).bytes(SWARM_PAIR_BYTES)
    d = Digest.from_bytes(data)
    ostore = store_with(root, "origin", {d: data})
    (mi,), gen_launches = metainfo(tracker, ostore, {d: data})
    seeder = peer(tracker, ostore, OriginTorrentArchive)
    astore = CAStore(os.path.join(root, "agent"))
    agent = peer(tracker, astore, AgentTorrentArchive)

    async def pair():
        seeder.seed(mi, SWARM_NS)
        counters.start()
        await agent.download(SWARM_NS, d)
        return await counters.stop()

    r = await run("pair", [seeder, agent], pair())
    identical(astore, d, data, "pair")
    check_swarm_leg("pair", r, 1, 1, mi.num_pieces)
    r.update({"gbps": SWARM_PAIR_BYTES / r["wall_s"] / 1e9, "needed_pieces": mi.num_pieces,
              "metainfo_launches": gen_launches})
    results["pair"] = r
    emit({"phase": "swarm", "leg": "pair", "config": "BASELINE.json config 1's blob, one agent",
          "blob_bytes": SWARM_PAIR_BYTES, "pieces": mi.num_pieces, "piece_length": PIECE,
          "timeout_s": SWARM_TIMEOUT_S["pair"], "card": card_name_power, **r})
    del data
    shutil.rmtree(root, ignore_errors=True)

    # (c) A corrupt seeder serves one piece with a flipped byte. It is the
    # agent's only peer until the agent has rejected that piece on the card
    # and blacklisted it; then a good seeder joins and the pull completes.
    tracker = SwarmTracker(SWARM_TRACKER_INTERVAL)
    data = np.random.default_rng(SEED + 40).bytes(SWARM_CORRUPT_BYTES)
    d = Digest.from_bytes(data)
    bad = bytearray(data)
    bad[SWARM_CORRUPT_PIECE * PIECE + 1234] ^= 0x01
    good_store = store_with(root, "good", {d: data})
    (mi,), gen_launches = metainfo(tracker, good_store, {d: data})
    evil = peer(tracker, store_with(root, "evil", {d: bytes(bad)}, lie=True),
                OriginTorrentArchive)
    good = peer(tracker, good_store, OriginTorrentArchive)
    events = Producer("agent")
    astore = CAStore(os.path.join(root, "agent"))
    agent = peer(tracker, astore, AgentTorrentArchive, events=events)
    del bad

    async def corrupt():
        evil.seed(mi, SWARM_NS)
        counters.start()
        t0 = time.perf_counter()
        pull = asyncio.create_task(agent.download(SWARM_NS, d))
        while not agent.conn_state.blacklist.blocked(evil.peer_id, mi.info_hash):
            if pull.done():
                await pull  # raises what ended it
                raise AssertionError("swarm corrupt: completed from the corrupt seeder")
            await asyncio.sleep(0.01)
        rejected_after = time.perf_counter() - t0
        good.seed(mi, SWARM_NS)
        await pull
        return await counters.stop(), rejected_after

    r, rejected_after = await run("corrupt", [evil, good, agent], corrupt())
    identical(astore, d, data, "corrupt")
    bans = [e for e in events.events
            if e["name"] == "blacklist_conn" and e.get("peer") == evil.peer_id.hex]
    if not any("digest mismatch" in e.get("reason", "") for e in bans):
        raise AssertionError(f"swarm corrupt: no digest-mismatch ban of the seeder: {bans}")
    check_swarm_leg("corrupt", r, 1, 1, mi.num_pieces)
    r.update({"bans": [e["reason"] for e in bans], "needed_pieces": mi.num_pieces,
              "metainfo_launches": gen_launches,
              "rejected_after_s": rejected_after})
    results["corrupt"] = r
    emit({"phase": "swarm", "leg": "corrupt", "blob_bytes": SWARM_CORRUPT_BYTES,
          "pieces": mi.num_pieces, "corrupt_piece": SWARM_CORRUPT_PIECE,
          "timeout_s": SWARM_TIMEOUT_S["corrupt"], "card": card_name_power, **r})
    shutil.rmtree(root, ignore_errors=True)
    return results


# -- phase 12, the tracker fleet ---------------------------------------------
TRACKERS = 3
TRACKER_KILL_S = 1.0  # the latest the owner dies, if no agent has a piece yet
TRACKER_TIMEOUT_S = 180.0
TRACKER_SETTLE_S = 30.0  # for the breakers to name the dead owner


class FleetOrigin:
    """The trackers' ``origin_cluster``: hands out the metainfo the seeder's
    ``Generator`` built on the card, and counts the fetches."""

    def __init__(self, metainfos):
        self.metainfos = {mi.digest.hex: mi for mi in metainfos}
        self.fetches = 0

    async def get_metainfo(self, namespace, d):
        self.fetches += 1
        return self.metainfos[d.hex]


class CountingCache:
    """A tracker's metainfo TTL cache, counting its lookups and hits."""

    def __init__(self, cache):
        self._cache = cache
        self.lookups = 0
        self.hits = 0

    def get(self, key):
        self.lookups += 1
        hit = self._cache.get(key)
        self.hits += hit is not None
        return hit

    def put(self, key, value) -> None:
        self._cache.put(key, value)


def fleet_ports(big_hash: str, small_hash: str, candidates: int = 16) -> list[int]:
    """Three free loopback ports, picked so that the smaller layer's owner
    is the tracker the larger layer does NOT fail over to: each tracker then
    has announces to answer before the kill (two of them) and after it (both
    survivors). Which ports the fleet gets is all that is picked: the
    owners follow from ``rendezvous_hash`` over the addresses."""
    from itertools import combinations

    from kraken_tpu_torch.placement.hrw import rendezvous_hash

    for trio in combinations(free_ports(candidates), TRACKERS):
        addrs = [f"127.0.0.1:{p}" for p in trio]
        ranked = rendezvous_hash(big_hash, addrs, k=TRACKERS)
        if rendezvous_hash(small_hash, addrs, k=1)[0] == ranked[2]:
            return list(trio)
    raise AssertionError("tracker: no fleet layout among the candidate ports")


async def tracker_fleet(root: str, card_name_power: str) -> dict:
    """Phase 12: the flash crowd of phase 11(a) announcing to, and fetching
    metainfo through, three port trackers over the port's HTTP/1.1, while
    the larger layer's shard owner is stopped mid-pull."""
    from kraken_tpu_torch import AgentTorrentArchive, BatchedVerifier, CAStore, OriginTorrentArchive
    from kraken_tpu_torch import get_hasher
    from kraken_tpu_torch.core.peer import PeerID
    from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
    from kraken_tpu_torch.placement import healthcheck
    from kraken_tpu_torch.placement.hrw import rendezvous_hash
    from kraken_tpu_torch.tracker.client import TrackerFleetClient, make_tracker_client
    from kraken_tpu_torch.tracker.peerstore import InMemoryPeerStore
    from kraken_tpu_torch.tracker.server import TrackerServer
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.metrics import REGISTRY

    hasher = get_hasher("cuda")
    counters = SwarmCounters(HashBatchTimer.of(hasher))
    layers = swarm_layers()
    ostore = store_with(root, "origin", layers)
    mis, gen_launches = card_metainfo(ostore, layers)
    small, big = sorted(mis, key=lambda mi: mi.length)
    origin = FleetOrigin(mis)

    class CountingStore(InMemoryPeerStore):
        """A tracker's peer store: the time of every announce it recorded
        (forwarded ones included)."""

        def __init__(self):
            super().__init__()
            self.announces: list[float] = []

        async def update(self, info_hash, peer, now=None):
            self.announces.append(time.perf_counter())
            await super().update(info_hash, peer, now)

    ports = fleet_ports(big.info_hash.hex, small.info_hash.hex)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    trackers = []
    for port in ports:
        server = TrackerServer(peer_store=CountingStore(), origin_cluster=origin,
                               announce_interval_seconds=SWARM_TRACKER_INTERVAL)
        server._metainfo_cache = CountingCache(server._metainfo_cache)
        runner, bound = await http_lite.serve(server.make_app(), "127.0.0.1", port)
        trackers.append({"addr": f"127.0.0.1:{bound}", "server": server, "runner": runner})
    for t in trackers:
        t["server"].set_fleet(addrs, t["addr"])
    owner = rendezvous_hash(big.info_hash.hex, addrs, k=1)[0]
    victim = next(t for t in trackers if t["addr"] == owner)

    def peer(store, archive_cls):
        pid = PeerID(os.urandom(20).hex())
        client = make_tracker_client(",".join(addrs), pid, "127.0.0.1", 0)
        if not isinstance(client, TrackerFleetClient):
            raise AssertionError(f"tracker: {type(client).__name__} is not a fleet client")
        verifier = BatchedVerifier(hasher=hasher, max_delay_seconds=0.002)
        s = Scheduler(pid, "127.0.0.1", 0, archive_cls(store, verifier), client, client,
                      config=SchedulerConfig())
        return s, client

    seeder = peer(ostore, OriginTorrentArchive)
    agents = [peer(CAStore(os.path.join(root, f"agent{i}")), AgentTorrentArchive)
              for i in range(SWARM_AGENTS)]
    peers = [seeder] + agents
    failovers = REGISTRY.counter("tracker_fleet_failovers_total")
    fleet_metrics = ("tracker_outages_total", "tracker_outage_seconds_total",
                     "announce_timeouts_total")
    before = {"announce": failovers.value(op="announce"),
              "tracker_metainfo": failovers.value(op="tracker_metainfo"),
              **{m: REGISTRY.counter(m).value() for m in fleet_metrics}}

    def pieces_of(mi) -> list[int]:
        """Each agent's pieces of ``mi`` done (verified and written)."""
        h = mi.info_hash
        return [s._controls[h].torrent.num_pieces_complete() if h in s._controls else 0
                for s, _c in agents]

    kill: dict = {}

    async def killer(t0):
        while time.perf_counter() - t0 < TRACKER_KILL_S and max(pieces_of(big)) < 1:
            await asyncio.sleep(0.002)
        kill["at_s"] = time.perf_counter() - t0
        kill["t"] = time.perf_counter()
        kill["pieces_done"] = {"alpine": sum(pieces_of(small)), "ubuntu": sum(pieces_of(big))}
        kill["agents_holding_an_ubuntu_piece"] = sum(1 for n in pieces_of(big) if n)
        await victim["runner"].cleanup()
        await victim["server"].close()
        kill["stop_s"] = time.perf_counter() - kill["t"]

    async def pull(s):
        t0 = time.perf_counter()
        await asyncio.gather(*(s.download(SWARM_NS, d) for d in layers))
        return time.perf_counter() - t0

    for s, client in peers:
        await s.start()
        client.port = s.port  # the p2p port is known once the scheduler binds
    try:
        for mi in mis:
            seeder[0].seed(mi, SWARM_NS)
        counters.start()
        t0 = time.perf_counter()
        kill_task = asyncio.create_task(killer(t0))
        secs = await asyncio.wait_for(asyncio.gather(*(pull(s) for s, _c in agents)),
                                      TRACKER_TIMEOUT_S)
        r = await counters.stop()
        await kill_task
        if kill["t"] - t0 >= min(secs):
            raise AssertionError(f"tracker: the kill at {kill['at_s']:.3f} s landed after a "
                                 f"pull ended ({min(secs):.3f} s)")
        # The peers go on announcing as seeders: wait until every survivor
        # has answered announces since the kill and a breaker names the
        # dead owner with its failures.
        survivors = [t for t in trackers if t is not victim]
        settle_t0 = time.perf_counter()
        named = {}
        while time.perf_counter() - settle_t0 < TRACKER_SETTLE_S:
            snap = healthcheck.debug_snapshot()
            named = {c.health.name: snap[c.health.name]["hosts"][owner]
                     for _s, c in peers
                     if owner in snap.get(c.health.name, {}).get("hosts", {})}
            after = [sum(1 for a in t["server"].peers.announces if a > kill["t"])
                     for t in survivors]
            if named and all(after):
                break
            await asyncio.sleep(0.05)
        settle_s = time.perf_counter() - settle_t0
    finally:
        for s, client in peers:
            await s.stop()
            await client.close()
        for t in trackers:
            if t is not victim:
                await t["runner"].cleanup()
                await t["server"].close()

    for i in range(SWARM_AGENTS):
        store = CAStore(os.path.join(root, f"agent{i}"))
        for d, data in layers.items():
            if store.read_cache_file(d) != data:
                raise AssertionError(f"tracker: agent {i}'s {d.hex[:12]} is not byte-identical")
    pieces = SWARM_AGENTS * sum(mi.num_pieces for mi in mis)
    check_swarm_leg("tracker", r, SWARM_AGENTS, len(layers), pieces)
    if not gen_launches["sha256_uniform"]:
        raise AssertionError("tracker: the seeder's metainfo launched no sha256_uniform")
    announces = {
        t["addr"]: {"role": ("dead owner" if t is victim else "survivor"),
                    "owns": [n for n, mi in zip(("alpine", "ubuntu"), (small, big))
                             if rendezvous_hash(mi.info_hash.hex, addrs, k=1)[0] == t["addr"]],
                    "before_kill": sum(1 for a in t["server"].peers.announces if a <= kill["t"]),
                    "after_kill": sum(1 for a in t["server"].peers.announces if a > kill["t"])}
        for t in trackers}
    dumb = [a for a, n in announces.items() if n["role"] == "survivor" and not n["after_kill"]]
    if dumb:
        raise AssertionError(f"tracker: survivors {dumb} answered no announce after the kill")
    if not any(h["consecutive_fails"] or h["state"] != "closed" for h in named.values()):
        raise AssertionError(f"tracker: no breaker names the dead owner {owner}: {named}")
    fleet = {"tracker_fleet_failovers_total": {
                 op: failovers.value(op=op) - before[op]
                 for op in ("announce", "tracker_metainfo")},
             **{m: REGISTRY.counter(m).value() - before[m] for m in fleet_metrics},
             "tracker_outage": REGISTRY.gauge("tracker_outage").value()}
    caches = [t["server"]._metainfo_cache for t in trackers]
    r.update({
        "pull_s_p50": float(np.percentile(secs, 50)), "pull_s_p99": float(np.percentile(secs, 99)),
        "pull_s": secs, "needed_pieces": pieces, "metainfo_launches": gen_launches,
        "bytes_needed": SWARM_AGENTS * sum(mi.length for mi in mis),
        "kill": {k: v for k, v in kill.items() if k != "t"}, "owner": owner,
        "announces": announces, "fleet": fleet,
        "breakers_naming_the_owner": len(named),
        "owner_in_breakers": sorted({(h["state"], h["consecutive_fails"])
                                     for h in named.values()}),
        "proxy": {"metainfo_fetches": origin.fetches,
                  "metainfo_lookups": sum(c.lookups for c in caches),
                  "metainfo_cache_hits": sum(c.hits for c in caches)},
        "settle_s": settle_s})
    r["wire_over_needed"] = r["bytes_down"] / r["bytes_needed"]
    emit({"phase": "tracker",
          "config": f"BASELINE.json config 2 through {TRACKERS} port trackers over http_lite, "
                    f"{SWARM_AGENTS} agents, the larger layer's shard owner stopped mid-pull",
          "layers": {n: s for n, s in SWARM_LAYERS},
          "pieces": [mi.num_pieces for mi in mis], "piece_length": PIECE,
          "timeout_s": TRACKER_TIMEOUT_S, "card": card_name_power, **r})
    return r


# -- phase 13, the origin over HTTP ------------------------------------------
# BASELINE.json config 1's blob (1 GiB, 4 MiB pieces) uploaded through the
# port's BlobClient to port OriginServers on http_lite. The other legs are
# cut to 128 MiB (resume, refresh, quorum) and 64 MiB (the pull) so that
# the phase stays near 30 s. ORIGIN_FLUSH is the server's flush batch
# (origin/server.py), which the resume leg's failpoint counts.
# ORIGIN_TRANSPORT_BYTES go through http_lite alone, with no origin, as
# the PATCH bodies and the GET the origin legs send.
ORIGIN_NS = "library/origin"
ORIGIN_BLOB = GiB
ORIGIN_RESUME_BYTES = 128 * MiB
ORIGIN_REFRESH_BYTES = 128 * MiB
ORIGIN_QUORUM_BYTES = 128 * MiB
ORIGIN_PULL_BYTES = 64 * MiB
ORIGIN_TRANSPORT_BYTES = 256 * MiB
ORIGIN_CHUNK = 16 * MiB  # BlobClient's PATCH body
ORIGIN_FLUSH = 8 * MiB
ORIGIN_RANGE = (123_456_789, 223_456_788)
ORIGIN_TIMEOUT_S = 300.0


class OriginLaunches:
    """Every wrapper's launch count, zeroed just before a leg and read
    just after it."""

    def __init__(self):
        from kraken_tpu_torch.ops import cdc_cuda, sha256_cuda, transpose_cuda

        self._mods = (sha256_cuda, cdc_cuda, transpose_cuda)

    def reset(self) -> None:
        for m in self._mods:
            m.reset_launches()

    def read(self) -> dict:
        out = {}
        for m in self._mods:
            out.update(m.LAUNCHES)
        return out


async def http_transport(nbytes: int) -> dict:
    """The port's HTTP/1.1 alone on loopback: ``nbytes`` PATCHed in
    ``ORIGIN_CHUNK`` bodies to a handler that reads them by
    ``iter_chunked(1 MiB)`` (the origin's PATCH read) and drops them, then
    GET back from a handler that writes 1 MiB slices (the origin's serve),
    through ``HTTPClient`` as the origin's clients do. What the origin legs'
    stream and download rates stand on."""
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.httputil import HTTPClient

    body = np.random.default_rng(SEED + 60).bytes(ORIGIN_CHUNK)
    app = http_lite.Application(client_max_size=GiB)

    async def sink(req):
        n = 0
        async for chunk in req.content.iter_chunked(MiB):
            n += len(chunk)
        return http_lite.Response(text=str(n))

    async def source(req):
        resp = http_lite.StreamResponse()
        resp.content_length = nbytes
        await resp.prepare(req)
        for off in range(0, nbytes, MiB):
            await resp.write(body[off % ORIGIN_CHUNK:off % ORIGIN_CHUNK + MiB])
        await resp.write_eof()
        return resp

    app.router.add_patch("/sink", sink)
    app.router.add_get("/source", source)
    runner, port = await http_lite.serve(app, "127.0.0.1", 0)
    client = HTTPClient(retries=0)
    try:
        t0 = time.perf_counter()
        for _ in range(nbytes // ORIGIN_CHUNK):
            got = await client.patch(f"http://127.0.0.1:{port}/sink", data=body)
            if int(got) != len(body):
                raise AssertionError(f"origin transport: the sink read {got} bytes")
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = await client.get(f"http://127.0.0.1:{port}/source")
        down_s = time.perf_counter() - t0
    finally:
        await client.close()
        await runner.cleanup()
    if len(got) != nbytes:
        raise AssertionError(f"origin transport: {len(got)} bytes back of {nbytes}")
    return {"patch_s": up_s, "patch_gbps": nbytes / up_s / 1e9,
            "get_s": down_s, "get_gbps": nbytes / down_s / 1e9}


def require_launches(leg: str, launches: dict, names) -> None:
    """Fail if a kernel of the leg's path was launched no time in it."""
    missing = [n for n in names if not launches.get(n)]
    if missing:
        raise AssertionError(f"origin {leg}: {missing} launched no time: {launches}")


async def origin_http(root: str, card_name_power: str) -> dict:
    """Phase 13: uploads to port ``OriginServer``s over the port's HTTP/1.1,
    every piece hashed on the card. Returns each leg's result."""
    from kraken_tpu_torch import (
        AgentTorrentArchive, BatchedVerifier, CAStore, DedupIndex, Digest, Generator,
        IngestConfig, IngestPipeline, MetaInfo, OriginTorrentArchive, PieceLengthConfig,
        get_hasher,
    )
    from kraken_tpu_torch.backend import Manager as BackendManager
    from kraken_tpu_torch.backend.base import make_backend
    from kraken_tpu_torch.core.peer import PeerID
    from kraken_tpu_torch.origin.blobrefresh import Refresher
    from kraken_tpu_torch.origin.client import BlobClient, ClusterClient
    from kraken_tpu_torch.origin.server import OriginServer, QuorumConfig
    from kraken_tpu_torch.origin.writeback import WritebackExecutor
    from kraken_tpu_torch.p2p.scheduler import Scheduler, SchedulerConfig
    from kraken_tpu_torch.persistedretry import Manager as RetryManager, TaskStore
    from kraken_tpu_torch.placement import HostList, Ring
    from kraken_tpu_torch.tracker.client import make_tracker_client
    from kraken_tpu_torch.tracker.server import TrackerServer
    from kraken_tpu_torch.utils import failpoints, http_lite, trace
    from kraken_tpu_torch.utils.httputil import HTTPClient
    from kraken_tpu_torch.utils.metrics import REGISTRY

    hasher = get_hasher("cuda")
    launches = OriginLaunches()
    pieces = PieceLengthConfig(((0, PIECE),))
    results: dict = {}
    rng = np.random.default_rng(SEED + 50)

    def host_hashing() -> dict:
        """What must not move: hashlib piece hashing, host verify batches."""
        return {"hashlib_pieces": REGISTRY.counter("hasher_pieces_total").value(hasher="cpu"),
                "verify_batches_host": REGISTRY.counter("verify_batches_total").value(path="host")}

    host_before = host_hashing()

    class TimedClient(BlobClient):
        """The port's BlobClient with its stream, commit and resume marked."""

        def __init__(self, addr: str):
            super().__init__(addr, HTTPClient(retries=0))
            self.marks: dict = {}
            self.offsets: list = []

        async def _start_upload(self, namespace, d):
            self.marks.setdefault("start", time.perf_counter())
            return await super()._start_upload(namespace, d)

        async def _session_offset(self, *a, **kw):
            t0 = time.perf_counter()
            off = await super()._session_offset(*a, **kw)
            self.offsets.append({"offset": off, "head_s": time.perf_counter() - t0})
            return off

        async def _commit_resumable(self, *a, **kw):
            self.marks["stream_end"] = time.perf_counter()
            await super()._commit_resumable(*a, **kw)
            self.marks["acked"] = time.perf_counter()

        async def timed_upload(self, d, data) -> dict:
            self.marks.clear()
            await asyncio.wait_for(self.upload(ORIGIN_NS, d, data, chunk_size=ORIGIN_CHUNK),
                                   ORIGIN_TIMEOUT_S)
            m = self.marks
            return {"stream_s": m["stream_end"] - m["start"],
                    "commit_s": m["acked"] - m["stream_end"],
                    "upload_to_201_s": m["acked"] - m["start"],
                    "stream_gbps": len(data) / (m["stream_end"] - m["start"]) / 1e9,
                    "gbps": len(data) / (m["acked"] - m["start"]) / 1e9}

    servers: list = []

    async def start_origin(name: str, *, pipeline=None, dedup=False, backend_root=None,
                           seed=False, ring=None, self_addr="", port=0, quorum=None):
        store = CAStore(os.path.join(root, name))
        gen = Generator(store, hasher=hasher, piece_lengths=pieces, pipeline=pipeline)
        retry = RetryManager(TaskStore(os.path.join(root, f"{name}.retry.db")))
        refresher = writeback = None
        if backend_root is not None:
            backends = BackendManager([{"namespace": ".*", "backend": "file",
                                        "config": {"root": backend_root}}])
            refresher = Refresher(store, backends, gen)
            writeback = WritebackExecutor(store, backends, retry)
        index = DedupIndex(store, hasher=hasher, device=hasher.device) if dedup else None
        server = OriginServer(store, gen, refresher=refresher, writeback=writeback, retry=retry,
                              ring=ring, self_addr=self_addr,
                              scheduler=await peer(store, OriginTorrentArchive) if seed else None,
                              dedup=index, ingest_pipeline=pipeline, quorum=quorum)
        runner, bound = await http_lite.serve(server.make_app(), "127.0.0.1", port)
        o = {"server": server, "runner": runner, "addr": f"127.0.0.1:{bound}", "store": store,
             "retry": retry, "name": name}
        servers.append(o)
        return o

    def exact(o, d, data, want: bytes, what: str) -> None:
        if o["store"].read_cache_file(d) != data:
            raise AssertionError(f"origin {what}: the blob on {o['name']} is not byte-identical")
        mi = o["server"].generator.get_cached(d)
        if mi is None or mi.piece_hashes != want:
            raise AssertionError(f"origin {what}: {o['name']}'s metainfo != hashlib")

    def last_span(name: str, d) -> dict:
        """The last span of ``name`` that the origins recorded for blob ``d``."""
        for sp in reversed(trace.TRACER.recorder.snapshot()):
            if sp["name"] == name and sp.get("attrs", {}).get("digest") == d.hex[:12]:
                return sp
        raise AssertionError(f"origin: no {name} span for {d.hex[:12]}")

    def commit_split(d) -> dict:
        """The commit handler's wall and its parts, from its span."""
        sp = last_span("origin.ingest.commit", d)
        return {"handler_s": sp["duration_s"],
                **{k: v for k, v in sp["attrs"].items() if k != "digest"}}

    # The tracker of leg (g), up first: origin A's scheduler announces to it.
    tracker = TrackerServer(announce_interval_seconds=SWARM_TRACKER_INTERVAL)
    tracker._metainfo_cache = CountingCache(tracker._metainfo_cache)
    t_runner, t_port = await http_lite.serve(tracker.make_app(), "127.0.0.1", 0)
    t_addr = f"127.0.0.1:{t_port}"
    peers: list = []

    async def peer(store, archive_cls):
        """A started port Scheduler announcing to leg (g)'s tracker."""
        pid = PeerID(os.urandom(20).hex())
        client = make_tracker_client(t_addr, pid, "127.0.0.1", 0)
        verifier = BatchedVerifier(hasher=hasher, max_delay_seconds=0.002)
        s = Scheduler(pid, "127.0.0.1", 0, archive_cls(store, verifier), client, client,
                      config=SchedulerConfig())
        peers.append((s, client))
        await s.start()
        client.port = s.port
        return s

    cluster = None
    trace_config = trace.TRACER.config
    trace.TRACER.apply(trace.TraceConfig(sample_rate=1.0))  # every span kept
    try:
        r = await asyncio.wait_for(http_transport(ORIGIN_TRANSPORT_BYTES), ORIGIN_TIMEOUT_S)
        results["transport"] = r
        emit({"phase": "origin_http", "leg": "transport", "what": "http_lite alone, no origin",
              "bytes": ORIGIN_TRANSPORT_BYTES, "patch_body": ORIGIN_CHUNK,
              "card": card_name_power, **r})

        # (a) and (b) are wired alike (a DedupIndex, a file backend taking
        # writeback, a seeding scheduler) but for the pipeline, so their acks
        # differ only by where the pieces are hashed. Each commit's split is
        # read from the origin's own spans.
        data = rng.bytes(ORIGIN_BLOB)
        d = Digest.from_bytes(data)
        want = hashlib_pieces(data, PIECE)
        want_mi = MetaInfo(d, len(data), PIECE, want).serialize()
        a_vs_b = {}
        for leg, pipe in (("a", None), ("b", IngestPipeline(hasher, IngestConfig()))):
            o = await start_origin(leg, pipeline=pipe, dedup=True, seed=True,
                                   backend_root=os.path.join(root, f"backend_{leg}"))
            stream_plen = o["server"]._stream_piece_length
            if (stream_plen, o["server"]._stream_hash_pool) != (PIECE if pipe else 0, None):
                raise AssertionError(f"origin {leg}: stream-time piece length {stream_plen}")
            c = TimedClient(o["addr"])
            launches.reset()
            r = await c.timed_upload(d, data)
            r["launches_at_201"] = launches.read()
            t0 = time.perf_counter()
            await asyncio.gather(*o["server"]._dedup_tasks)
            r["dedup_wait_after_201_s"] = time.perf_counter() - t0
            r["dedup_s"] = last_span("origin.dedup.add", d)["duration_s"]
            r["launches"] = launches.read()
            require_launches(leg, r["launches_at_201"], ["sha256_uniform"])
            require_launches(f"{leg} dedup", r["launches"], ["sha256_ragged", "gear_candidates"])
            r["commit_split"] = split = commit_split(d)
            split["outside_handler_s"] = r["commit_s"] - split["handler_s"]
            if split["digest_from"] != "stream":
                raise AssertionError(f"origin {leg}: the commit re-read a streamed upload")
            if pipe is None:
                gen = last_span("origin.metainfo.generate", d)
                split.update({"generate_s": gen["duration_s"], **{
                    f"generate_{k}": gen["attrs"][k] for k in ("hash_s", "read_wait_s")}})
            elif "ingest_hash" not in split:
                raise AssertionError("origin b: the commit did not take the stream-time digests")
            exact(o, d, data, want, leg)
            got_mi = (await c.get_metainfo(ORIGIN_NS, d)).serialize()
            if got_mi != want_mi:
                raise AssertionError(f"origin {leg}: GET /metainfo != MetaInfo over hashlib's")
            if o["server"].dedup.stats()["blobs"] != 1:
                raise AssertionError(f"origin {leg}: the dedup index did not index the blob")
            r.update({"metainfo_bytes": len(got_mi), "pieces": len(want) // 32, "checks": [
                "piece hashes == hashlib", "GET /metainfo == MetaInfo(hashlib)",
                "blob byte-identical", "dedup indexed", "commit took the stream digest"]})
            results[leg] = r
            a_vs_b[leg] = (o, c)
            what = ("commit-time pass, no pipeline" if pipe is None else
                    "stream-time pass, IngestConfig(): host, 64 MiB windows, 2 in flight")
            emit({"phase": "origin_http", "leg": leg, "what": what, "blob_bytes": len(data),
                  "piece_length": PIECE, "card": card_name_power, **r})
        a, client = a_vs_b["a"]
        await a_vs_b["b"][1].close()
        ra, rb = results["a"], results["b"]
        emit({"phase": "origin_http", "leg": "a_vs_b",
              "acks_sooner": "a (commit-time)" if ra["upload_to_201_s"] < rb["upload_to_201_s"]
              else "b (stream-time)",
              **{k: {"a": ra[k], "b": rb[k]} for k in ("upload_to_201_s", "stream_s",
                                                       "commit_s")},
              "card": card_name_power})

        # (c) Resume: a PATCH fails half way; the client HEADs and resumes.
        # The failed PATCH invalidates the session's tracker; the HEAD drops
        # it and re-adopts the session from its journal by re-reading the
        # spool, and the commit takes the digest of that re-read.
        data_c = rng.bytes(ORIGIN_RESUME_BYTES)
        dc = Digest.from_bytes(data_c)
        want_c = hashlib_pieces(data_c, PIECE)
        adopted = REGISTRY.counter("upload_sessions_adopted_total")
        adopted0 = adopted.value()
        flushes = ORIGIN_RESUME_BYTES // ORIGIN_FLUSH
        failpoints.FAILPOINTS.arm("origin.patch.write", f"every:{flushes // 2}+times:1")
        launches.reset()
        try:
            r = await client.timed_upload(dc, data_c)
            fired = failpoints.FAILPOINTS.snapshot()["failpoints"]["origin.patch.write"]["fired"]
        finally:
            failpoints.FAILPOINTS.disarm_all()
        r["launches_at_201"] = launches.read()
        await asyncio.gather(*a["server"]._dedup_tasks)
        r["launches"] = launches.read()
        require_launches("c", r["launches_at_201"], ["sha256_uniform"])
        if fired != 1 or not client.offsets:
            raise AssertionError(f"origin c: the failpoint fired {fired} times, "
                                 f"{len(client.offsets)} resumes")
        if adopted.value() != adopted0 + 1:
            raise AssertionError("origin c: the session was not re-adopted from its journal")
        resumed = client.offsets[-1]["offset"]
        r["commit_split"] = split = commit_split(dc)
        if (split["digest_from"], split["replayed_bytes"]) != ("stream", resumed) or not resumed:
            raise AssertionError(f"origin c: the commit's digest came from {split['digest_from']} "
                                 f"after re-reading {split['replayed_bytes']} B, resumed at "
                                 f"{resumed} B")
        exact(a, dc, data_c, want_c, "c")
        r.update({"resumed_at": client.offsets, "sessions_adopted": adopted.value() - adopted0,
                  "reread_bytes": split["replayed_bytes"], "failpoint_at_flush": flushes // 2,
                  "checks": ["one fire, one re-adoption",
                             "commit digest from the spool re-read up to the resumed offset",
                             "blob byte-identical", "metainfo == hashlib"]})
        results["c"] = r
        emit({"phase": "origin_http", "leg": "c", "what": "resume after a failed PATCH",
              "blob_bytes": len(data_c), "card": card_name_power, **r})

        # (d) Download: the 1 GiB back, whole and by range.
        t0 = time.perf_counter()
        got = await asyncio.wait_for(client.download(ORIGIN_NS, d), ORIGIN_TIMEOUT_S)
        down_s = time.perf_counter() - t0
        if got != data:
            raise AssertionError("origin d: the download is not byte-identical")
        del got
        url = f"http://{a['addr']}/namespace/{ORIGIN_NS.replace('/', '%2F')}/blobs/{d.hex}"
        lo, hi = ORIGIN_RANGE
        async with http_lite.ClientSession() as session:
            async with session.get(url, headers={"Range": f"bytes={lo}-{hi}"}) as resp:
                part, status, crange = await resp.read(), resp.status, resp.headers.get(
                    "Content-Range")
            async with session.get(url, headers={"Range": f"bytes={len(data)}-"}) as resp:
                await resp.read()
                past = resp.status
        if (status, crange, part) != (206, f"bytes {lo}-{hi}/{len(data)}", data[lo:hi + 1]):
            raise AssertionError(f"origin d: range answer {status} {crange}")
        if past != 416:
            raise AssertionError(f"origin d: a range past the end answered {past}")
        r = {"download_s": down_s, "gbps": len(data) / down_s / 1e9, "range_status": status,
             "range_bytes": len(part), "past_eof_status": past,
             "checks": ["200 byte-identical", "206 == slice", "416 past EOF"]}
        results["d"] = r
        emit({"phase": "origin_http", "leg": "d", "what": "download", "blob_bytes": len(data),
              "card": card_name_power, **r})

        # (e) Refresh from a file backend, and writeback of (a)'s blob.
        data_e = rng.bytes(ORIGIN_REFRESH_BYTES)
        de = Digest.from_bytes(data_e)
        want_e = hashlib_pieces(data_e, PIECE)
        backend_e = os.path.join(root, "backend_e")
        await make_backend("file", {"root": backend_e}).upload(ORIGIN_NS, de.hex, data_e)
        e = await start_origin("e", backend_root=backend_e)
        client_e = BlobClient(e["addr"])
        launches.reset()
        t0 = time.perf_counter()
        got = await asyncio.wait_for(client_e.download(ORIGIN_NS, de), ORIGIN_TIMEOUT_S)
        refresh_s = time.perf_counter() - t0
        r = {"refresh_s": refresh_s, "launches": launches.read()}
        require_launches("e", r["launches"], ["sha256_uniform"])
        if got != data_e:
            raise AssertionError("origin e: the refreshed blob is not byte-identical")
        exact(e, de, data_e, want_e, "e")
        await client_e.close()
        del got
        t0 = time.perf_counter()
        written = await asyncio.wait_for(a["retry"].run_once(), ORIGIN_TIMEOUT_S)
        r["writeback_s"] = time.perf_counter() - t0
        back = await make_backend("file", {"root": os.path.join(root, "backend_a")}).download(
            ORIGIN_NS, d.hex)
        if back != data:
            raise AssertionError("origin e: the written-back blob is not byte-identical")
        del back
        r.update({"writeback_tasks_done": written, "checks": [
            "refreshed blob byte-identical", "metainfo == hashlib", "writeback byte-identical"]})
        results["e"] = r
        emit({"phase": "origin_http", "leg": "e", "what": "refresh and writeback",
              "blob_bytes": len(data_e), "writeback_bytes": len(data),
              "card": card_name_power, **r})

        # (f) Quorum: three origins on one ring, write_quorum 2.
        qports = free_ports(3)
        addrs = [f"127.0.0.1:{p}" for p in qports]
        ring = Ring(HostList(static=addrs), max_replica=3)
        q = [await start_origin(f"q{i}", ring=ring, self_addr=addrs[i], port=qports[i],
                                quorum=QuorumConfig(write_quorum=2, push_timeout_seconds=60.0)
                                if i == 0 else None) for i in range(3)]
        data_f = rng.bytes(ORIGIN_QUORUM_BYTES)
        df = Digest.from_bytes(data_f)
        want_f = hashlib_pieces(data_f, PIECE)
        quorum_ok = REGISTRY.counter("origin_quorum_writes_total")
        quorum0 = quorum_ok.value(outcome="quorum")
        client_f = TimedClient(q[0]["addr"])
        launches.reset()
        r = await client_f.timed_upload(df, data_f)
        holders = [o["name"] for o in q[1:] if o["store"].in_cache(df)]
        if not holders or quorum_ok.value(outcome="quorum") != quorum0 + 1:
            raise AssertionError(f"origin f: acked with replicas {holders}")
        owner_mi = q[0]["server"].generator.get_cached(df).serialize()
        for o in q[1:]:
            if o["name"] in holders:
                if o["server"].generator.get_cached(df).serialize() != owner_mi:
                    raise AssertionError(f"origin f: {o['name']}'s metainfo != the owner's")
        t0 = time.perf_counter()
        drained = await asyncio.wait_for(q[0]["retry"].run_once(), ORIGIN_TIMEOUT_S)
        r["drain_s"] = time.perf_counter() - t0
        r["launches"] = launches.read()
        require_launches("f", r["launches"], ["sha256_uniform"])
        for o in q:
            exact(o, df, data_f, want_f, "f")
            if o["server"].generator.get_cached(df).serialize() != owner_mi:
                raise AssertionError(f"origin f: {o['name']}'s metainfo != the owner's")
        r.update({"ack_s": r["upload_to_201_s"], "holders_at_201": holders,
                  "replication_tasks_done": drained, "checks": [
                      "201 after a replica held the blob", "replica metainfo == owner's",
                      "all three byte-identical"]})
        await client_f.close()
        results["f"] = r
        emit({"phase": "origin_http", "leg": "f", "what": "write_quorum 2 of 3",
              "blob_bytes": len(data_f), "card": card_name_power, **r})

        # (g) Through the tracker: an agent pulls what origin A seeds.
        cluster = ClusterClient(Ring(HostList(static=[a["addr"]]), max_replica=1))
        tracker.origin_cluster = cluster
        data_g = rng.bytes(ORIGIN_PULL_BYTES)
        dg = Digest.from_bytes(data_g)
        want_g = hashlib_pieces(data_g, PIECE)
        await client.timed_upload(dg, data_g)
        await asyncio.gather(*a["server"]._dedup_tasks)
        exact(a, dg, data_g, want_g, "g")
        agent_store = CAStore(os.path.join(root, "agent"))
        agent = await peer(agent_store, AgentTorrentArchive)
        counters = SwarmCounters(HashBatchTimer.of(hasher))
        counters.start()
        await asyncio.wait_for(agent.download(ORIGIN_NS, dg), ORIGIN_TIMEOUT_S)
        r = await counters.stop()
        if agent_store.read_cache_file(dg) != data_g:
            raise AssertionError("origin g: the pulled blob is not byte-identical")
        pieces_g = len(want_g) // 32
        check_swarm_leg("origin g", r, 1, 1, pieces_g)
        cache = tracker._metainfo_cache
        if not cache.lookups:
            raise AssertionError("origin g: the agent's metainfo did not come through the tracker")
        r.update({"gbps": len(data_g) / r["wall_s"] / 1e9, "needed_pieces": pieces_g,
                  "tracker_metainfo_lookups": cache.lookups,
                  "tracker_metainfo_cache_hits": cache.hits,
                  "checks": ["pulled blob byte-identical", "every piece verified on the card",
                             "metainfo through the tracker's proxy"]})
        results["g"] = r
        emit({"phase": "origin_http", "leg": "g", "what": "upload -> origin -> metainfo -> "
              "tracker -> pull -> verify", "blob_bytes": len(data_g), "card": card_name_power,
              **r})
        await client.close()
    finally:
        for s, c in peers:
            await s.stop()
            await c.close()
        for o in servers:
            await o["runner"].cleanup()
            await o["server"].close_heal_cluster()
            o["retry"].close()
        await t_runner.cleanup()
        await tracker.close()
        if cluster is not None:
            await cluster.close()
        trace.TRACER.apply(trace_config)

    host_after = host_hashing()
    if host_after != host_before:
        raise AssertionError(f"origin: host hashing moved: {host_before} -> {host_after}")
    return results


# -- phase 14, the herd -----------------------------------------------------
# Origin, tracker and agent as three processes of the port's CLI, each from
# a config that extends the shipped config/<component>/base.yaml and
# overrides only its address, ports, store, backends and peers. BASELINE.json
# config 1's blob: 1 GiB of 4 MiB pieces, seeded.
HERD_NS = "library/herd"
HERD_BLOB = GiB
HERD_HASHER = "cuda"
HERD_READY_S = 120.0
HERD_SIGHUP_S = 15.0
HERD_TIMEOUT_S = 300.0
HERD_WINDOW = 64 * MiB  # the shipped ingest.window_bytes and the gear pass's window


class HerdChild:
    """One ``python -m kraken_tpu_torch.cli`` child: its READY document,
    its time to READY, its stderr in a file. With ``wait=False`` the
    caller starts several and then calls ``wait_ready`` on each. ``env``
    adds to the environment it inherits."""

    def __init__(self, root: str, name: str, args: list[str], wait: bool = True,
                 env: dict | None = None):
        self.name = name
        self.err_path = os.path.join(root, f"{name}.stderr")
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kraken_tpu_torch.cli", *args],
            stdout=subprocess.PIPE, stderr=open(self.err_path, "w"), cwd=REPO, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO), **(env or {})),
        )
        self._ready = threading.Event()
        self._ready_at = 0.0
        self.ready: dict = {}

        def read() -> None:
            for line in self.proc.stdout:
                if line.startswith("READY "):
                    self._ready_at = time.perf_counter()
                    self.ready.update(json.loads(line[6:]))
                    self._ready.set()
            self._ready.set()

        threading.Thread(target=read, daemon=True).start()
        if wait:
            self.wait_ready()

    def wait_ready(self) -> None:
        self._ready.wait(HERD_READY_S)
        if not self.ready:
            self.stop(kill=True)
            sys.stderr.write(f"--- herd {self.name} stderr ---\n{self.log()[-8000:]}\n")
            raise AssertionError(f"herd: {self.name} died or hung before READY "
                                 f"(rc {self.proc.returncode})")
        self.ready_s = self._ready_at - self._t0
        self.addr = self.ready["addr"]

    def log(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def metrics(self) -> str:
        with urllib.request.urlopen(f"http://{self.addr}/metrics", timeout=30) as r:
            return r.read().decode()

    def stop(self, kill: bool = False) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL if kill else signal.SIGTERM)
        return self.proc.wait(timeout=60)


def metric(text: str, name: str, **labels) -> float:
    """One sample of a Prometheus text exposition (0 when absent)."""
    want = "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}" if labels else ""
    for line in text.splitlines():
        if line.startswith(name + want + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def delta(before: str, after: str, name: str, **labels) -> float:
    """How far one sample moved between two expositions."""
    return metric(after, name, **labels) - metric(before, name, **labels)


def herd_config(root: str, component: str, extra: str = "", name: str = "",
                backends: str = "backends: []") -> str:
    """A config extending the shipped base by its relative path, with only
    the keys the component reads: host and ports, its store, its
    ``backends`` section (none by default). ``name`` (default: the
    component) names the file and the store, for two nodes of one
    component."""
    name = name or component
    base = os.path.relpath(REPO / "config" / component / "base.yaml", root)
    path = os.path.join(root, f"{name}.yaml")
    body = [f"extends: {base}", "host: 127.0.0.1", "port: 0"]
    if component in ("origin", "agent"):
        body += ["p2p_port: 0"]
    if component in ("origin", "agent", "build-index"):
        body += [f"store: {os.path.join(root, name)}"]
    if component in ("origin", "build-index"):
        body += [backends.rstrip("\n")]
    with open(path, "w") as f:
        f.write("\n".join(body) + "\n" + extra)
    return path


def herd_phase(root: str, card_name_power: str) -> dict:
    """Phase 14: the three-process herd. Returns the numbers and the
    children's counters that the kernels line carries."""
    from kraken_tpu_torch import Digest, MetaInfo
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.httputil import HTTPClient

    children: list[HerdChild] = []
    hasher = ["--hasher", HERD_HASHER]
    try:
        t_cfg = herd_config(root, "tracker")
        o_cfg = herd_config(root, "origin")
        a_extra = "scheduler:\n  wire_send_batch: 16\n"
        a_cfg = herd_config(root, "agent", a_extra)
        # The tracker needs the origin's address for its metainfo proxy
        # and the origin needs the tracker's: start a tracker, then the
        # origin pointed at it, then the tracker again on its port with
        # the origin (the reference herd's dance).
        first = HerdChild(root, "tracker0", ["tracker", "--config", t_cfg])
        children.append(first)
        origin = HerdChild(root, "origin", ["origin", "--config", o_cfg, "--tracker",
                                            first.addr, *hasher])
        children.append(origin)
        if first.stop() != 0:
            raise AssertionError("herd: the first tracker did not exit 0")
        children.remove(first)
        tracker = HerdChild(root, "tracker", ["tracker", "--config", t_cfg, "--port",
                                              first.addr.rsplit(":", 1)[1], "--origins",
                                              origin.addr])
        children.append(tracker)
        agent = HerdChild(root, "agent", ["agent", "--config", a_cfg, "--tracker",
                                          tracker.addr, *hasher])
        children.append(agent)
        ready = {c.name: c.ready_s for c in (first, origin, tracker, agent)}
        emit({"phase": "herd", "ready_s": ready, "addrs": {c.name: c.addr for c in children},
              "what": "time from spawn to READY: interpreter, torch import, CUDA context, "
                      "kernel library load, fsck, listeners", "card": card_name_power})

        rng = np.random.default_rng(SEED + 70)
        blob = rng.bytes(HERD_BLOB)
        d = Digest.from_bytes(blob)
        want_pieces = hashlib_pieces(blob, PIECE)
        o0, a0 = origin.metrics(), agent.metrics()

        async def upload_and_pull() -> dict:
            marks: dict = {}

            class Timed(BlobClient):
                async def _start_upload(self, namespace, dd):
                    marks.setdefault("start", time.perf_counter())
                    return await super()._start_upload(namespace, dd)

                async def _commit_resumable(self, *a, **kw):
                    marks["stream_end"] = time.perf_counter()
                    await super()._commit_resumable(*a, **kw)
                    marks["acked"] = time.perf_counter()

            client = Timed(origin.addr, HTTPClient(retries=0))
            http = HTTPClient(retries=0, timeout_seconds=HERD_TIMEOUT_S)
            try:
                await asyncio.wait_for(client.upload(HERD_NS, d, blob, chunk_size=ORIGIN_CHUNK),
                                       HERD_TIMEOUT_S)
                # The agent answers once its swarm pull has finished, then
                # streams the blob: the response head marks the pull's
                # end, the body the serve.
                url = f"http://{agent.addr}/namespace/{quote(HERD_NS, safe='')}/blobs/{d.hex}"
                timeout = http_lite.ClientTimeout(total=HERD_TIMEOUT_S)
                async with http_lite.ClientSession(timeout=timeout) as session:
                    t0 = time.perf_counter()
                    async with session.get(url) as resp:
                        head_s = time.perf_counter() - t0
                        got = await resp.read()
                    pull_s = time.perf_counter() - t0
                if resp.status != 200:
                    raise AssertionError(f"herd: GET on the agent answered {resp.status}")
                mi_raw = await http.get(
                    f"http://{tracker.addr}/namespace/{quote(HERD_NS, safe='')}/blobs/"
                    f"{d.hex}/metainfo")
            finally:
                await client.close()
                await http.close()
            return {"got": got, "pull_s": pull_s, "head_s": head_s, "mi_raw": mi_raw,
                    "marks": marks}

        r = asyncio.run(upload_and_pull())
        if r["got"] != blob:
            raise AssertionError("herd: the blob through the agent is not byte-identical")
        want_mi = MetaInfo(d, len(blob), PIECE, want_pieces)
        if r["mi_raw"] != want_mi.serialize():
            raise AssertionError("herd: GET /metainfo through the tracker != MetaInfo over "
                                 "hashlib's piece hashes")
        o1, a1 = origin.metrics(), agent.metrics()
        m = r["marks"]
        pieces = len(want_pieces) // 32
        # The origin's dedup pass runs after the 201 (chunking on the gear
        # kernel, fingerprints through the cuda hasher): wait for it, so
        # that every counter below holds the whole path.
        deadline = time.perf_counter() + HERD_TIMEOUT_S
        while metric(o1, "origin_dedup_indexed_blobs") < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("herd: the origin's dedup pass did not finish")
            time.sleep(0.5)
            o1 = origin.metrics()

        kernels = ("sha256_uniform", "sha256_ragged", "gear_candidates")
        got = {
            "origin_cuda_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cuda"),
            "origin_cpu_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cpu"),
            "origin_ingest_windows": delta(o0, o1, "ingest_windows_total", hasher="cuda"),
            "origin_dedup_chunks": delta(o0, o1, "origin_dedup_unique_chunks"),
            "origin_dedup_duplicate_bytes": delta(o0, o1, "origin_dedup_duplicate_bytes"),
            "agent_cuda_batches": delta(a0, a1, "verify_batches_total", path="cuda"),
            "agent_host_batches": delta(a0, a1, "verify_batches_total", path="host"),
            "agent_verified_pieces": delta(a0, a1, "verify_pieces_total"),
            "agent_cuda_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cuda"),
            "agent_cpu_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cpu"),
            "origin_launches": {k: delta(o0, o1, "kernel_launches_total", kernel=k)
                                for k in kernels},
            "agent_launches": {k: delta(a0, a1, "kernel_launches_total", kernel=k)
                               for k in kernels},
        }
        # The origin hashed on the card: the blob's 256 pieces through its
        # ingest pipeline's windows at stream time, plus its dedup chunks'
        # fingerprints (a random blob has no duplicate chunk), and nothing
        # with hashlib.
        if (got["origin_cpu_pieces"] or got["origin_dedup_duplicate_bytes"]
                or got["origin_cuda_pieces"] != pieces + got["origin_dedup_chunks"]
                or got["origin_ingest_windows"] != -(-HERD_BLOB // HERD_WINDOW)):
            raise AssertionError(f"herd: origin piece hashing {got}")
        if got["agent_cuda_batches"] < 1 or got["agent_host_batches"] or got["agent_cpu_bytes"]:
            raise AssertionError(f"herd: agent verify {got}")
        if got["agent_cuda_bytes"] < HERD_BLOB or got["agent_verified_pieces"] < pieces:
            raise AssertionError(f"herd: the agent verified less than the blob on the card: {got}")
        # The dedup pass's router times both chunk paths once on a sample
        # (gear launches) and keeps the faster for the process; it routes
        # the windows to the card only when the card won.
        got["origin_chunk_route_bps"] = {
            path: metric(o1, "dedup_chunk_route_bps", path=path) for path in ("host", "device")}
        if (not got["origin_launches"]["sha256_uniform"] or not got["agent_launches"]["sha256_ragged"]
                or not got["origin_launches"]["sha256_ragged"]
                or not got["origin_launches"]["gear_candidates"]):
            raise AssertionError(f"herd: a kernel of the path did not launch: {got}")
        emit({"phase": "herd", "leg": "upload", "blob_bytes": HERD_BLOB,
              "stream_s": m["stream_end"] - m["start"], "commit_s": m["acked"] - m["stream_end"],
              "upload_to_201_s": m["acked"] - m["start"],
              "stream_gbps": HERD_BLOB / (m["stream_end"] - m["start"]) / 1e9,
              "origin_launches": got["origin_launches"],
              "origin_ingest_windows": got["origin_ingest_windows"],
              "origin_cuda_pieces": got["origin_cuda_pieces"],
              "origin_dedup_chunks": got["origin_dedup_chunks"],
              "origin_chunk_route_bps": got["origin_chunk_route_bps"], "card": card_name_power})
        batches = got["agent_cuda_batches"]
        emit({"phase": "herd", "leg": "pull", "blob_bytes": HERD_BLOB, "pieces": pieces,
              "pull_s": r["pull_s"], "gbps": HERD_BLOB / r["pull_s"] / 1e9,
              "swarm_pull_s": r["head_s"], "serve_s": r["pull_s"] - r["head_s"],
              "verify_batches": batches, "rows_per_batch": got["agent_verified_pieces"] / batches,
              "agent_launches": got["agent_launches"], "agent_cuda_bytes": got["agent_cuda_bytes"],
              "checks": ["blob byte-identical through the agent's HTTP API",
                         "GET /metainfo through the tracker == MetaInfo over hashlib",
                         f"{pieces} pieces hashed on the card at the origin, none by hashlib",
                         "every verify batch on the card at the agent"],
              "card": card_name_power})

        # SIGHUP: the agent re-reads its config and applies the scheduler.
        herd_config(root, "agent", "scheduler:\n  wire_send_batch: 8\n")
        t0 = time.perf_counter()
        agent.proc.send_signal(signal.SIGHUP)
        while '"wire_send_batch": 8' not in agent.log():
            if time.perf_counter() - t0 > HERD_SIGHUP_S:
                raise AssertionError("herd: SIGHUP did not apply scheduler.wire_send_batch: "
                                     + agent.log()[-2000:])
            time.sleep(0.1)
        sighup_s = time.perf_counter() - t0

        # SIGTERM: each child drains, then exits 0, within its shipped
        # rpc.drain_timeout_seconds.
        drains = {}
        for c in (agent, origin, tracker):
            cfg = load_config(str(REPO / "config" / c.name / "base.yaml"))
            limit = RPCConfig.from_dict(cfg.get("rpc")).drain_timeout_seconds
            t0 = time.perf_counter()
            rc = c.stop()
            drains[c.name] = time.perf_counter() - t0
            if rc != 0 or drains[c.name] > limit or "drain quiesced" not in c.log():
                raise AssertionError(f"herd: {c.name} exit {rc} after {drains[c.name]:.1f} s:\n"
                                     + c.log()[-3000:])
        children.clear()
        emit({"phase": "herd", "leg": "signals", "sighup_applied_s": sighup_s,
              "drain_to_exit_s": drains, "card": card_name_power})
        return {"ready_s": ready, "pull_s": r["pull_s"], "counters": got,
                "upload_to_201_s": m["acked"] - m["start"]}
    finally:
        for c in children:
            c.stop(kill=True)


# -- phase 15, the front door -------------------------------------------------
# docker push to the proxy, docker pull by tag from the agent's registry
# endpoint: tracker, origin, build-index, proxy and agent as five processes of
# the port's CLI, from configs extending the shipped base files. The image:
# a config blob, BASELINE.json config 2's two layers (``swarm_layers()``) and
# config 1's 1 GiB as a third layer, the size of an ML image's framework layer.
FRONT_REPO = "library/app"
FRONT_TAG = "v1"
FRONT_BIG = GiB
FRONT_CHUNK = 16 * MiB  # docker's PATCH bodies, as BlobClient's
FRONT_TIMEOUT_S = 300.0
DOCKER2 = "application/vnd.docker.distribution.manifest.v2+json"
DOCKER_ACCEPT = [("Accept", DOCKER2),
                 ("Accept", "application/vnd.docker.distribution.manifest.list.v2+json"),
                 ("Accept", "application/vnd.oci.image.manifest.v1+json")]
REGISTRY_VERSION = ("Docker-Distribution-API-Version", "registry/2.0")


class UploadWatch:
    """Marks the proxy's finalize from the origin's store tree, polled
    every 2 ms on a thread: when the proxy's upload session appears under
    ``upload/`` (its digest done), when that file holds every byte (its
    upload stream done), and when the blob lands in ``cache/`` (the
    origin's commit done)."""

    def __init__(self, store_root: str, hex_: str, size: int):
        self.upload_dir = os.path.join(store_root, "upload")
        self.cache_path = os.path.join(store_root, "cache", hex_[:2], hex_[2:4], hex_)
        self.size = size
        self.marks: dict = {}
        self._stop = threading.Event()
        self._before = set(os.listdir(self.upload_dir))
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            if "cached" not in self.marks:
                new = set(os.listdir(self.upload_dir)) - self._before
                if new and "upload_seen" not in self.marks:
                    self.marks["upload_seen"] = now
                for name in new:
                    with contextlib.suppress(OSError):
                        if os.path.getsize(os.path.join(self.upload_dir, name)) >= self.size:
                            self.marks.setdefault("upload_full", now)
                if os.path.exists(self.cache_path):
                    self.marks["cached"] = now
            time.sleep(0.002)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        return self.marks


def front_door_image() -> tuple[list[bytes], bytes]:
    """The image's blobs (config first) and its schema2 manifest."""
    from kraken_tpu_torch import Digest

    layers = [*swarm_layers().values(), np.random.default_rng(SEED + 80).bytes(FRONT_BIG)]
    config = json.dumps({"architecture": "amd64", "os": "linux",
                         "rootfs": {"type": "layers", "diff_ids": [
                             str(Digest.from_bytes(b)) for b in layers]}}).encode()
    manifest = json.dumps({
        "schemaVersion": 2, "mediaType": DOCKER2,
        "config": {"mediaType": "application/vnd.docker.container.image.v1+json",
                   "size": len(config), "digest": str(Digest.from_bytes(config))},
        "layers": [{"mediaType": "application/vnd.docker.image.rootfs.diff.tar.gzip",
                    "size": len(b), "digest": str(Digest.from_bytes(b))} for b in layers],
    }).encode()
    return [config, *layers], manifest


def front_door_phase(root: str, card_name_power: str) -> dict:
    """Phase 15: push through the proxy, pull by tag through the agent.
    Returns the numbers and the children's counters that the kernels line
    carries."""
    from kraken_tpu_torch import Digest
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.origin.metainfogen import PieceLengthConfig
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.deadline import RPCConfig

    children: list[HerdChild] = []
    hasher = ["--hasher", HERD_HASHER]
    try:
        # Every child at once, each on a port picked beforehand, so that
        # none waits for another's READY.
        t_port, o_port, b_port, p_port = free_ports(4)
        t_addr, o_addr, b_addr = (f"127.0.0.1:{p}" for p in (t_port, o_port, b_port))
        specs = {
            "tracker": ["--port", str(t_port), "--origins", o_addr],
            "origin": ["--port", str(o_port), "--tracker", t_addr, *hasher],
            "build-index": ["--port", str(b_port), "--origins", o_addr],
            "proxy": ["--port", str(p_port), "--origins", o_addr, "--build-index", b_addr],
            "agent": ["--tracker", t_addr, "--build-index", b_addr, *hasher],
        }
        for name, flags in specs.items():
            extra = "registry_port: 0\n" if name == "agent" else ""
            cfg = herd_config(root, name, extra)
            children.append(HerdChild(root, name, [name, "--config", cfg, *flags], wait=False))
        for c in children:
            c.wait_ready()
        tracker, origin, bindex, proxy, agent = children
        registry = agent.ready.get("registry_addr")
        if not registry:
            raise AssertionError(f"front door: the agent reported no registry: {agent.ready}")
        ready = {c.name: c.ready_s for c in children}
        emit({"phase": "front_door", "ready_s": ready,
              "addrs": {**{c.name: c.addr for c in children}, "agent_registry": registry},
              "what": "five processes started together; time from spawn to READY (the "
                      "build-index and the proxy load no kernel library)",
              "card": card_name_power})

        blobs, manifest = front_door_image()
        digests = [Digest.from_bytes(b) for b in blobs]
        m_digest = Digest.from_bytes(manifest)
        lengths = PieceLengthConfig()
        origin_blobs = [*blobs, manifest]
        pieces = sum(-(-len(b) // lengths.piece_length(len(b))) for b in origin_blobs)
        windows = sum(-(-len(b) // HERD_WINDOW) for b in origin_blobs)
        layer_bytes = sum(len(b) for b in blobs)
        o0, a0 = origin.metrics(), agent.metrics()
        timeout = http_lite.ClientTimeout(total=FRONT_TIMEOUT_S)
        versions: list[str | None] = []

        def seen(resp) -> None:
            versions.append(resp.headers.get(REGISTRY_VERSION[0]))

        async def push() -> list[dict]:
            base = f"http://{proxy.addr}/v2/{FRONT_REPO}"
            out = []
            async with http_lite.ClientSession(timeout=timeout) as s:
                for blob, d in zip(blobs, digests):
                    leg = {"blob_bytes": len(blob)}
                    async with s.request("HEAD", f"{base}/blobs/{d}") as r:
                        seen(r)
                        if r.status != 404:
                            raise AssertionError(f"front door: HEAD before push {r.status}")
                    async with s.request("POST", f"{base}/blobs/uploads/") as r:
                        seen(r)
                        await r.read()
                        if r.status != 202 or "Location" not in r.headers:
                            raise AssertionError(f"front door: POST {r.status}")
                        loc = f"http://{proxy.addr}{r.headers['Location']}"
                    view = memoryview(blob)
                    t0 = time.perf_counter()
                    for off in range(0, len(blob), FRONT_CHUNK):
                        async with s.request("PATCH", loc, data=view[off:off + FRONT_CHUNK]) as r:
                            seen(r)
                            await r.read()
                            if r.status != 202:
                                raise AssertionError(f"front door: PATCH {r.status}")
                    t1 = time.perf_counter()
                    watch = UploadWatch(os.path.join(root, "origin"), d.hex, len(blob))
                    try:
                        async with s.request("PUT", f"{loc}?digest={d}") as r:
                            seen(r)
                            body = await r.read()
                            t2 = time.perf_counter()
                    finally:
                        marks = watch.stop()
                    if r.status != 201:
                        raise AssertionError(f"front door: PUT ?digest= {r.status} {body[:300]}")
                    leg.update(patch_s=t1 - t0, patch_gbps=len(blob) / (t1 - t0) / 1e9,
                               finalize_s=t2 - t1, to_201_s=t2 - t0)
                    if {"upload_seen", "upload_full", "cached"} <= set(marks):
                        leg.update(proxy_digest_s=marks["upload_seen"] - t1,
                                   upload_to_origin_s=marks["upload_full"] - marks["upload_seen"],
                                   origin_commit_s=marks["cached"] - marks["upload_full"],
                                   after_commit_s=t2 - marks["cached"])
                    out.append(leg)
                t0 = time.perf_counter()
                async with s.request("PUT", f"{base}/manifests/{FRONT_TAG}", data=manifest,
                                     headers={"Content-Type": DOCKER2}) as r:
                    seen(r)
                    await r.read()
                    if r.status != 201 or r.headers.get("Docker-Content-Digest") != str(m_digest):
                        raise AssertionError(f"front door: manifest PUT {r.status}")
                out.append({"manifest_put_s": time.perf_counter() - t0})
            return out

        t0 = time.perf_counter()
        pushed = asyncio.run(push())
        push_s = time.perf_counter() - t0

        async def pull(timed: bool) -> dict:
            base = f"http://{registry}/v2/{FRONT_REPO}"
            got = {"blobs": []}
            async with http_lite.ClientSession(timeout=timeout) as s:
                t0 = time.perf_counter()
                async with s.request("GET", f"{base}/manifests/{FRONT_TAG}",
                                     headers=DOCKER_ACCEPT) as r:
                    seen(r)
                    head_s = time.perf_counter() - t0
                    body = await r.read()
                if r.status != 200 or body != manifest:
                    raise AssertionError(f"front door: manifest by tag {r.status}, "
                                         f"identical {body == manifest}")
                got["manifest"] = {"swarm_s": head_s, "serve_s": time.perf_counter() - t0 - head_s}
                doc = json.loads(body)
                for ref in [doc["config"], *doc["layers"]]:
                    h = hashlib.sha256()
                    t0 = time.perf_counter()
                    async with s.request("GET", f"{base}/blobs/{ref['digest']}") as r:
                        seen(r)
                        head_s = time.perf_counter() - t0
                        async for chunk in r.content.iter_chunked(1 << 20):
                            h.update(chunk)
                    wall = time.perf_counter() - t0
                    if r.status != 200 or "sha256:" + h.hexdigest() != ref["digest"]:
                        raise AssertionError(f"front door: blob {ref['digest'][:19]} "
                                             f"{r.status}, digest {h.hexdigest()[:12]}")
                    got["blobs"].append({"blob_bytes": ref["size"], "swarm_s": head_s,
                                         "serve_s": wall - head_s,
                                         "gbps": ref["size"] / wall / 1e9})
                if not timed:
                    return got
                big = str(digests[-1])
                async with s.request("HEAD", f"{base}/blobs/{big}") as r:
                    seen(r)
                    if r.status != 200 or r.headers.get("Content-Length") != str(FRONT_BIG):
                        raise AssertionError(f"front door: HEAD {r.status} "
                                             f"{r.headers.get('Content-Length')}")
                mid = FRONT_BIG // 2 + 12_345
                h = hashlib.sha256()
                t0 = time.perf_counter()
                async with s.request("GET", f"{base}/blobs/{big}",
                                     headers={"Range": f"bytes={mid}-"}) as r:
                    seen(r)
                    async for chunk in r.content.iter_chunked(1 << 20):
                        h.update(chunk)
                    got["range"] = {"status": r.status, "bytes": FRONT_BIG - mid,
                                    "content_range": r.headers.get("Content-Range"),
                                    "s": time.perf_counter() - t0}
                if (r.status != 206 or h.digest() != hashlib.sha256(
                        memoryview(blobs[-1])[mid:]).digest()
                        or got["range"]["content_range"] != f"bytes {mid}-{FRONT_BIG - 1}/{FRONT_BIG}"):
                    raise AssertionError(f"front door: Range resume {got['range']}")
                async with s.request("GET", f"{base}/tags/list") as r:
                    seen(r)
                    tags = await r.json()
                if tags != {"name": FRONT_REPO, "tags": [FRONT_TAG]}:
                    raise AssertionError(f"front door: tags/list {tags}")
                async with s.request("POST", f"{base}/blobs/uploads/") as r:
                    seen(r)
                    err = await r.json()
                got["read_only"] = (r.status, err["errors"][0]["code"])
                if got["read_only"] != (405, "UNSUPPORTED"):
                    raise AssertionError(f"front door: POST to the agent {got['read_only']}")
            return got

        t0 = time.perf_counter()
        first = asyncio.run(pull(timed=True))
        pull_s = time.perf_counter() - t0
        # Every counter below holds the whole path: wait for the origin's
        # dedup pass over each blob it committed.
        o1 = origin.metrics()
        deadline = time.perf_counter() + FRONT_TIMEOUT_S
        while (metric(o1, "origin_dedup_indexed_blobs")
               - metric(o0, "origin_dedup_indexed_blobs") < len(origin_blobs)):
            if time.perf_counter() > deadline:
                raise AssertionError("front door: the origin's dedup pass did not finish")
            time.sleep(0.5)
            o1 = origin.metrics()
        a1 = agent.metrics()
        t0 = time.perf_counter()
        second = asyncio.run(pull(timed=False))
        second_s = time.perf_counter() - t0
        a2 = agent.metrics()
        kernels = ("sha256_uniform", "sha256_ragged", "gear_candidates")
        got = {
            "origin_cuda_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cuda"),
            "origin_cpu_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cpu"),
            "origin_ingest_windows": delta(o0, o1, "ingest_windows_total", hasher="cuda"),
            "origin_dedup_chunks": delta(o0, o1, "origin_dedup_unique_chunks"),
            "origin_dedup_duplicate_bytes": delta(o0, o1, "origin_dedup_duplicate_bytes"),
            "origin_chunk_route_bps": {path: metric(o1, "dedup_chunk_route_bps", path=path)
                                       for path in ("host", "device")},
            "agent_cuda_batches": delta(a0, a1, "verify_batches_total", path="cuda"),
            "agent_host_batches": delta(a0, a1, "verify_batches_total", path="host"),
            "agent_verified_pieces": delta(a0, a1, "verify_pieces_total"),
            "agent_cuda_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cuda"),
            "agent_cpu_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cpu"),
            "origin_launches": {k: delta(o0, o1, "kernel_launches_total", kernel=k)
                                for k in kernels},
            "agent_launches": {k: delta(a0, a1, "kernel_launches_total", kernel=k)
                               for k in kernels},
            "second_pull_agent_launches": {k: delta(a1, a2, "kernel_launches_total", kernel=k)
                                           for k in kernels},
            "second_pull_verify_batches": delta(a1, a2, "verify_batches_total", path="cuda")
            + delta(a1, a2, "verify_batches_total", path="host"),
        }
        if (got["origin_cpu_pieces"] or got["origin_dedup_duplicate_bytes"]
                or got["origin_cuda_pieces"] != pieces + got["origin_dedup_chunks"]
                or got["origin_ingest_windows"] != windows):
            raise AssertionError(f"front door: origin piece hashing, {pieces} pieces and "
                                 f"{windows} windows expected: {got}")
        if got["agent_cuda_batches"] < 1 or got["agent_host_batches"] or got["agent_cpu_bytes"]:
            raise AssertionError(f"front door: agent verify {got}")
        if got["agent_cuda_bytes"] < layer_bytes or got["agent_verified_pieces"] < pieces:
            raise AssertionError(f"front door: the agent verified less than the image on the "
                                 f"card: {got}")
        if (not got["origin_launches"]["sha256_uniform"] or not got["agent_launches"]["sha256_ragged"]
                or not got["origin_launches"]["sha256_ragged"]
                or not got["origin_launches"]["gear_candidates"]):
            raise AssertionError(f"front door: a kernel of the path did not launch: {got}")
        if any(got["second_pull_agent_launches"].values()) or got["second_pull_verify_batches"]:
            raise AssertionError(f"front door: the second pull verified again: {got}")
        if any(v != REGISTRY_VERSION[1] for v in versions):
            raise AssertionError(f"front door: a registry answer lacks {REGISTRY_VERSION}")
        with urllib.request.urlopen(
                f"http://{bindex.addr}/tags/{quote(f'{FRONT_REPO}:{FRONT_TAG}', safe='')}",
                timeout=30) as r:
            tag_digest = r.read().decode()
        if tag_digest != str(m_digest):
            raise AssertionError(f"front door: the build-index holds {tag_digest}")
        emit({"phase": "front_door", "leg": "push", "blobs": pushed, "push_s": push_s,
              "origin_pieces": pieces, "origin_ingest_windows": got["origin_ingest_windows"],
              "origin_cuda_pieces": got["origin_cuda_pieces"],
              "origin_dedup_chunks": got["origin_dedup_chunks"],
              "origin_launches": got["origin_launches"],
              "origin_chunk_route": max(got["origin_chunk_route_bps"],
                                        key=got["origin_chunk_route_bps"].get),
              "origin_chunk_route_bps": got["origin_chunk_route_bps"],
              "what": "per blob: PATCH stream into the proxy; finalize = the proxy's hashlib "
                      "digest of its spool, its upload_from_file to the origin, the origin's "
                      "commit (marked from the origin's store tree)", "card": card_name_power})
        batches = got["agent_cuda_batches"]
        emit({"phase": "front_door", "leg": "pull", "pull_s": pull_s, "first": first,
              "second_pull_s": second_s, "second": second,
              "verify_batches": batches, "rows_per_batch": got["agent_verified_pieces"] / batches,
              "agent_launches": got["agent_launches"], "agent_cuda_bytes": got["agent_cuda_bytes"],
              "second_pull_agent_launches": got["second_pull_agent_launches"],
              "checks": ["manifest by tag byte-identical (docker's three Accept lines)",
                         "every blob's SHA-256 = its digest", "HEAD Content-Length",
                         "Range resume = the slice (206)", "tags/list", "POST -> UNSUPPORTED",
                         "the version header on every answer",
                         "build-index tag = the manifest's digest",
                         f"{pieces} pieces hashed on the card at the origin, none by hashlib",
                         "every verify batch on the card at the agent",
                         "the second pull launched nothing"],
              "card": card_name_power})

        # SIGTERM: each child exits 0 within its rpc.drain_timeout_seconds
        # (the build-index and the proxy have no drain: they stop at once).
        drains = {}
        for c in (agent, proxy, bindex, origin, tracker):
            cfg = load_config(str(REPO / "config" / c.name / "base.yaml"))
            limit = RPCConfig.from_dict(cfg.get("rpc")).drain_timeout_seconds
            t0 = time.perf_counter()
            rc = c.stop()
            drains[c.name] = time.perf_counter() - t0
            quiesced = c.name in ("build-index", "proxy") or "drain quiesced" in c.log()
            if rc != 0 or drains[c.name] > limit or not quiesced:
                raise AssertionError(f"front door: {c.name} exit {rc} after "
                                     f"{drains[c.name]:.1f} s:\n" + c.log()[-3000:])
        children.clear()
        emit({"phase": "front_door", "leg": "signals", "drain_to_exit_s": drains,
              "card": card_name_power})
        return {"ready_s": ready, "push_s": push_s, "pull_s": pull_s, "counters": got}
    finally:
        for c in children:
            c.stop(kill=True)


# -- phase 16, delta pulls over the chunk tier ----------------------------------
# Two consecutive builds of one layer, made by the reference's recipe
# (tests/test_delta.py ``_make_build_pair``) scaled to the shipped 64 KiB
# average chunk: 1024 files of 1 MiB (16 average chunks a file, as the
# reference's 16 KiB files hold at its 1 KiB average), a 64 B unique header
# before each, build 2 reusing 80 % of build 1's files, shuffled. Tracker,
# origin (delta and chunk tier on), agent A (delta and chunk tier on) and
# agent B (the shipped values: both off, the control) as four CLI processes.
DELTA_NS = "library/delta"
DELTA_FILES = 1024
DELTA_FILE = MiB
DELTA_REUSE = 0.8
DELTA_BAND_MAX = 0.6  # the reference's BAND_MAX (tests/test_delta.py:37)
DELTA_TIMEOUT_S = 300.0
DELTA_ON = "delta:\n  enabled: true\nchunkstore:\n  enabled: true\n"
DELTA_KERNELS = ("sha256_uniform", "sha256_ragged", "sha256_packed_tiles",
                 "pack_tiles_device", "gear_candidates", "transpose_only")


def make_build_pair(rng, n_files: int, file_bytes: int, reuse: float) -> tuple[bytes, bytes]:
    """The reference's build pair: (64 B unique header + file) per member,
    build 2 keeping ``reuse`` of build 1's files in shuffled order."""
    files = [rng.integers(0, 256, size=file_bytes, dtype=np.uint8).tobytes()
             for _ in range(2 * n_files)]

    def layer(members):
        parts = []
        for fi in members:
            parts.append(rng.integers(0, 256, size=64, dtype=np.uint8).tobytes())
            parts.append(files[fi])
        return b"".join(parts)

    m1 = list(range(n_files))
    n_keep = int(n_files * reuse)
    m2 = m1[:n_keep] + list(range(n_files, 2 * n_files - n_keep))
    rng.shuffle(m2)
    return layer(m1), layer(m2)


def require_delta_path(got: dict) -> None:
    """The gates that read where the work ran: no host verify batch in
    either agent, and the kernels of the path launched in each process."""
    if got["a_host_batches"] or got["b_host_batches"]:
        raise AssertionError(f"delta: a verify batch ran on the host: {got}")
    if got["origin_cpu_pieces"]:
        raise AssertionError(f"delta: the origin hashed pieces with hashlib: {got}")
    o, a, b = got["origin_launches"], got["a_launches"], got["b_launches"]
    if not (o["sha256_uniform"] and o["sha256_ragged"] and o["gear_candidates"]
            and a["sha256_ragged"] and b["sha256_ragged"]):
        raise AssertionError(f"delta: a kernel of the path did not launch: {got}")


def delta_phase(root: str, card_name_power: str) -> dict:
    """Phase 16: build 1 and build 2 uploaded to a chunk-tier origin,
    pulled by a delta agent and by a control. Returns the numbers and
    the children's counters that the kernels line carries."""
    from kraken_tpu_torch import CAStore, Digest
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.httputil import HTTPClient

    t0 = time.perf_counter()
    builds = make_build_pair(np.random.default_rng(SEED + 160), DELTA_FILES, DELTA_FILE,
                             DELTA_REUSE)
    digests = [Digest.from_bytes(b) for b in builds]
    corpus_s = time.perf_counter() - t0
    children: list[HerdChild] = []
    hasher = ["--hasher", HERD_HASHER]
    try:
        t_port, o_port = free_ports(2)
        t_addr, o_addr = f"127.0.0.1:{t_port}", f"127.0.0.1:{o_port}"
        specs = [
            ("tracker", "tracker", "", ["--port", str(t_port), "--origins", o_addr]),
            ("origin", "origin", DELTA_ON, ["--port", str(o_port), "--tracker", t_addr, *hasher]),
            ("agent_a", "agent", DELTA_ON, ["--tracker", t_addr, *hasher]),
            ("agent_b", "agent", "", ["--tracker", t_addr, *hasher]),
        ]
        for name, component, extra, flags in specs:
            cfg = herd_config(root, component, extra, name)
            children.append(HerdChild(root, name, [component, "--config", cfg, *flags],
                                      wait=False))
        for c in children:
            c.wait_ready()
        tracker, origin, agent_a, agent_b = children
        ready = {c.name: c.ready_s for c in children}
        emit({"phase": "delta", "ready_s": ready, "corpus_s": corpus_s,
              "build_bytes": [len(b) for b in builds],
              "addrs": {c.name: c.addr for c in children}, "card": card_name_power})
        o0, a0, b0 = origin.metrics(), agent_a.metrics(), agent_b.metrics()

        async def upload() -> list[float]:
            client = BlobClient(origin.addr, HTTPClient(retries=0))
            walls = []
            try:
                for blob, d in zip(builds, digests):
                    t0 = time.perf_counter()
                    await asyncio.wait_for(
                        client.upload(DELTA_NS, d, blob, chunk_size=ORIGIN_CHUNK), DELTA_TIMEOUT_S)
                    walls.append(time.perf_counter() - t0)
            finally:
                await client.close()
            return walls

        upload_s = asyncio.run(upload())
        # The origin's dedup pass builds each build's recipe (gear kernel,
        # fingerprints on the card), then converts the blob to manifest and
        # chunks: wait for both conversions.
        t0 = time.perf_counter()
        o1 = origin.metrics()
        while delta(o0, o1, "chunkstore_converts_total", outcome="converted") < 2:
            if time.perf_counter() - t0 > DELTA_TIMEOUT_S:
                raise AssertionError("delta: the origin did not convert both builds: "
                                     + origin.log()[-3000:])
            time.sleep(0.25)
            o1 = origin.metrics()
        convert_wait_s = time.perf_counter() - t0
        ostore = CAStore(os.path.join(root, "origin"))
        for d in digests:
            if os.path.exists(ostore.cache_path(d)) or not os.path.exists(
                    ostore.cache_path(d) + "._md_chunk_manifest"):
                raise AssertionError(f"delta: the origin holds {d.hex[:12]} flat")
        origin_tier = {"stored_bytes": metric(o1, "chunkstore_stored_bytes"),
                       "logical_bytes": metric(o1, "chunkstore_logical_bytes"),
                       "dedup_chunks": delta(o0, o1, "origin_dedup_unique_chunks"),
                       "add_s": delta(o0, o1, "chunkstore_seconds_total", stage="add"),
                       "check_s": delta(o0, o1, "chunkstore_seconds_total", stage="check"),
                       "mismatch": delta(o0, o1, "chunkstore_converts_total",
                                         outcome="mismatch")}
        if origin_tier["logical_bytes"] != sum(len(b) for b in builds) or origin_tier["mismatch"]:
            raise AssertionError(f"delta: the origin's chunk tier {origin_tier}")

        async def pull(agent: HerdChild, blob: bytes, d) -> dict:
            """GET on the agent's API: the response head marks the end of
            the pull (metainfo, delta prefill, swarm), the body the serve."""
            url = f"http://{agent.addr}/namespace/{quote(DELTA_NS, safe='')}/blobs/{d.hex}"
            before = agent.metrics()
            h = hashlib.sha256()
            n = 0
            same = True
            timeout = http_lite.ClientTimeout(total=DELTA_TIMEOUT_S)
            async with http_lite.ClientSession(timeout=timeout) as session:
                t0 = time.perf_counter()
                async with session.get(url) as resp:
                    head_s = time.perf_counter() - t0
                    async for chunk in resp.content.iter_chunked(1 << 20):
                        same = same and chunk == blob[n:n + len(chunk)]
                        n += len(chunk)
                        h.update(chunk)
                wall = time.perf_counter() - t0
            after = agent.metrics()
            if resp.status != 200 or not same or n != len(blob) or h.hexdigest() != d.hex:
                raise AssertionError(f"delta: {agent.name} pulled {d.hex[:12]}: status "
                                     f"{resp.status}, {n} B, identical {same}")

            def moved(name, **labels):
                return delta(before, after, name, **labels)

            stages = {k: moved("delta_stage_seconds_total", stage=k)
                      for k in ("prefill", "plan", "copy", "recheck", "fetch", "write")}
            batches = moved("verify_batches_total", path="cuda")
            return {
                "agent": agent.name, "blob_bytes": len(blob), "wall_s": wall,
                "head_s": head_s, "serve_s": wall - head_s,
                "serve_gbps": len(blob) / max(wall - head_s, 1e-9) / 1e9,
                "prefill_s": stages["prefill"], "stages_s": stages,
                "swarm_s": head_s - stages["prefill"],
                "piece_bytes_down": moved("p2p_piece_bytes_down_total"),
                "fetched_bytes": moved("delta_bytes_fetched_total"),
                "copied_bytes": moved("delta_bytes_copied_local_total"),
                "delta_pulls": {o: moved("delta_pulls_total", outcome=o)
                                for o in ("delta", "no_base", "no_cover", "recipe_miss")},
                "chunk_rejects": moved("delta_chunk_verify_failures_total"),
                "verify_batches": batches,
                "host_batches": moved("verify_batches_total", path="host"),
                "rows_per_batch": moved("verify_pieces_total") / batches if batches else 0.0,
                "launches": {k: moved("kernel_launches_total", kernel=k) for k in DELTA_KERNELS},
            }

        legs = {}
        for key, agent, i in (("a_build1", agent_a, 0), ("a_build2", agent_a, 1),
                              ("b_build2", agent_b, 1)):
            ob = origin.metrics()
            r = asyncio.run(pull(agent, builds[i], digests[i]))
            r["moved_bytes"] = r["piece_bytes_down"] + r["fetched_bytes"]
            r["moved_ratio"] = r["moved_bytes"] / len(builds[i])
            r["origin_piece_bytes_up"] = delta(ob, origin.metrics(), "p2p_piece_bytes_up_total")
            legs[key] = r
            emit({"phase": "delta", "leg": key, **r, "card": card_name_power})
        # Build 1's only seeder was the origin, which holds it in its chunk
        # tier: every piece came through a composed chunk reader.
        if legs["a_build1"]["origin_piece_bytes_up"] < len(builds[0]):
            raise AssertionError(f"delta: the chunk-backed origin did not seed build 1: "
                                 f"{legs['a_build1']}")
        # Agent A converts each completed pull into its chunk tier in the
        # background: wait for both, then read its tier.
        t0 = time.perf_counter()
        a1 = agent_a.metrics()
        while delta(a0, a1, "chunkstore_converts_total", outcome="converted") < 2:
            if time.perf_counter() - t0 > DELTA_TIMEOUT_S:
                raise AssertionError("delta: agent A did not convert both pulls: "
                                     + agent_a.log()[-3000:])
            time.sleep(0.25)
            a1 = agent_a.metrics()
        b1 = agent_b.metrics()
        o2 = origin.metrics()
        agent_tier = {"stored_bytes": metric(a1, "chunkstore_stored_bytes"),
                      "logical_bytes": metric(a1, "chunkstore_logical_bytes"),
                      "add_s": delta(a0, a1, "chunkstore_seconds_total", stage="add"),
                      "check_s": delta(a0, a1, "chunkstore_seconds_total", stage="check")}
        got = {
            "origin_launches": {k: delta(o0, o2, "kernel_launches_total", kernel=k)
                                for k in DELTA_KERNELS},
            "a_launches": {k: delta(a0, a1, "kernel_launches_total", kernel=k)
                           for k in DELTA_KERNELS},
            "b_launches": {k: delta(b0, b1, "kernel_launches_total", kernel=k)
                           for k in DELTA_KERNELS},
            "a_host_batches": delta(a0, a1, "verify_batches_total", path="host"),
            "b_host_batches": delta(b0, b1, "verify_batches_total", path="host"),
            "origin_cuda_pieces": delta(o0, o2, "hasher_pieces_total", hasher="cuda"),
            "origin_cpu_pieces": delta(o0, o2, "hasher_pieces_total", hasher="cpu"),
            "origin_ingest_windows": delta(o0, o2, "ingest_windows_total", hasher="cuda"),
            "origin_chunk_route_bps": {path: metric(o2, "dedup_chunk_route_bps", path=path)
                                       for path in ("host", "device")},
        }
        a2, b2 = legs["a_build2"], legs["b_build2"]
        ratio = a2["moved_bytes"] / b2["moved_bytes"]
        if ratio > DELTA_BAND_MAX:
            raise AssertionError(f"delta: agent A's build-2 pull moved {ratio:.3f}x agent B's "
                                 f"(band <= {DELTA_BAND_MAX}): {a2} {b2}")
        if a2["copied_bytes"] <= 0 or a2["delta_pulls"]["delta"] != 1:
            raise AssertionError(f"delta: agent A copied nothing locally: {a2}")
        require_delta_path(got)
        emit({"phase": "delta", "leg": "tiers", "upload_s": upload_s,
              "convert_wait_s": convert_wait_s, "origin_tier": origin_tier,
              "agent_a_tier": agent_tier, "a_over_b_moved": ratio,
              "origin_cuda_pieces": got["origin_cuda_pieces"],
              "origin_ingest_windows": got["origin_ingest_windows"],
              "origin_launches": got["origin_launches"],
              "origin_chunk_route_bps": got["origin_chunk_route_bps"],
              "checks": ["every pull byte-identical, its SHA-256 = its digest",
                         "both builds chunk-backed at the origin, no flat file",
                         "the chunk-backed origin seeded all of build 1",
                         f"agent A's build-2 pull moved <= {DELTA_BAND_MAX}x agent B's",
                         "agent A copied bytes from its local base",
                         "no host verify batch in either agent",
                         "origin: sha256_uniform, sha256_ragged, gear_candidates launched; "
                         "agents: sha256_ragged launched"],
              "card": card_name_power})

        # SIGHUP: agent A turns delta off live and logs the planes' state.
        herd_config(root, "agent", "delta:\n  enabled: false\nchunkstore:\n  enabled: true\n",
                    "agent_a")
        t0 = time.perf_counter()
        agent_a.proc.send_signal(signal.SIGHUP)
        while '"delta_enabled": false' not in agent_a.log():
            if time.perf_counter() - t0 > HERD_SIGHUP_S:
                raise AssertionError("delta: SIGHUP did not turn delta off: "
                                     + agent_a.log()[-2000:])
            time.sleep(0.1)
        sighup_s = time.perf_counter() - t0

        drains = {}
        for c, component in ((agent_a, "agent"), (agent_b, "agent"), (origin, "origin"),
                             (tracker, "tracker")):
            cfg = load_config(str(REPO / "config" / component / "base.yaml"))
            limit = RPCConfig.from_dict(cfg.get("rpc")).drain_timeout_seconds
            t0 = time.perf_counter()
            rc = c.stop()
            drains[c.name] = time.perf_counter() - t0
            if rc != 0 or drains[c.name] > limit or "drain quiesced" not in c.log():
                raise AssertionError(f"delta: {c.name} exit {rc} after {drains[c.name]:.1f} s:\n"
                                     + c.log()[-3000:])
        children.clear()
        emit({"phase": "delta", "leg": "signals", "sighup_applied_s": sighup_s,
              "drain_to_exit_s": drains, "card": card_name_power})
        return {"ready_s": ready, "legs": legs, "counters": got, "ratio": ratio,
                "origin_tier": origin_tier, "agent_tier": agent_tier}
    finally:
        for c in children:
            c.stop(kill=True)


# -- phase 17, the operator's plane ---------------------------------------------
# Tracker, origin and agent as in phase 14, the agent with its canary probing
# the origin every OPERATOR_CANARY_S (the shipped 256 KiB blob), the shipped
# observe-only resources: and a 1 s SLO evaluation. The user pull is phase
# 14's 1 GiB, profiled through the agent's /debug/torch-profile while it runs.
OPERATOR_NS = "library/operator"
OPERATOR_BLOB = GiB
OPERATOR_CANARY_S = 2.0
OPERATOR_PROBES = 3
OPERATOR_PROFILE_S = 10.0
OPERATOR_PULL_LEAD_S = 3.0  # into the pull before the capture starts
OPERATOR_TIMEOUT_S = 300.0
ROWS_KERNEL_NAME = "sha256_rows_kernel"
# The debug mux every node serves (the reference's, torch-profile in place of
# jax-profile).
MUX_ROUTES = ("/metrics", "/debug", "/debug/", "/debug/slo", "/debug/trace",
              "/debug/healthcheck", "/debug/resources", "/debug/stacks",
              "/debug/pprof/profile", "/debug/pprof/heap", "/debug/pprof/looplag",
              "/debug/torch-profile", "/debug/failpoints")
SLO_KEYS = {"node", "enabled", "eval_interval_seconds", "windows", "firing", "last_eval",
            "canary"}
RESOURCES_KEYS = {"process", "sentinels"}
BREAKER_KEYS = {"kind", "fail_threshold", "cooldown_seconds", "brownout_threshold_seconds",
                "hosts"}
_HEX64 = re.compile(r'="[^"]*[0-9a-f]{64}[^"]*"')


def get_json(addr: str, path: str, timeout: float = 60.0):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def cli_tool(args: list[str], timeout: float = 120.0) -> tuple[int, str]:
    """``python -m kraken_tpu_torch.cli <args>``: its exit code and stdout
    (its stderr goes to this process's)."""
    proc = subprocess.run([sys.executable, "-m", "kraken_tpu_torch.cli", *args],
                          stdout=subprocess.PIPE, text=True, cwd=REPO, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    return proc.returncode, proc.stdout


def launches_of(text: str) -> dict:
    """Every ``kernel_launches_total{kernel}`` sample of an exposition."""
    got = {}
    for line in text.splitlines():
        if line.startswith('kernel_launches_total{kernel="'):
            got[line.split('"')[1]] = float(line.rsplit(" ", 1)[1])
    return got


def launch_rise(before: str, after: str) -> dict:
    b, a = launches_of(before), launches_of(after)
    return {k: a[k] - b.get(k, 0.0) for k in a if a[k] - b.get(k, 0.0)}


class ProbeLog:
    """Every canary probe document the agent's /debug/slo shows, by
    sequence number, polled on a thread."""

    def __init__(self, addr: str, every: float = 0.25):
        self.addr, self.every = addr, every
        self.probes: dict[int, dict] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            try:
                doc = get_json(self.addr, "/debug/slo", 10.0).get("canary")
            except OSError:
                continue
            if doc and doc.get("seq") is not None:
                self.probes[doc["seq"]] = doc

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10.0)

    def good(self) -> list[dict]:
        return [p for _s, p in sorted(self.probes.items()) if p.get("result") == "ok"]


def operator_phase(root: str, card_name_power: str) -> dict:
    """Phase 17: the canary, the debug mux, /debug/torch-profile during a
    user pull, the status/trace/flame tools, clean stops. Returns the
    numbers and the children's counters that the kernels line carries."""
    from kraken_tpu_torch import Digest
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.httputil import HTTPClient

    children: list[HerdChild] = []
    probes = None
    hasher = ["--hasher", HERD_HASHER]
    try:
        t_port, o_port = free_ports(2)
        t_addr, o_addr = f"127.0.0.1:{t_port}", f"127.0.0.1:{o_port}"
        a_extra = (f"canary:\n  enabled: true\n  origins: {o_addr}\n"
                   f"  interval_seconds: {OPERATOR_CANARY_S}\n"
                   "slo:\n  eval_interval_seconds: 1.0\n")
        specs = [
            ("tracker", "", ["--port", str(t_port), "--origins", o_addr]),
            ("origin", "", ["--port", str(o_port), "--tracker", t_addr, *hasher]),
            ("agent", a_extra, ["--tracker", t_addr, *hasher]),
        ]
        profile_dir = os.path.join(root, "torchprof")
        for name, extra, flags in specs:
            cfg = herd_config(root, name, extra)
            children.append(HerdChild(root, name, [name, "--config", cfg, *flags], wait=False,
                                      env={"KRAKEN_PROFILE_DIR": profile_dir}))
        for c in children:
            c.wait_ready()
        tracker, origin, agent = children
        ready = {c.name: c.ready_s for c in children}
        emit({"phase": "operator", "ready_s": ready,
              "addrs": {c.name: c.addr for c in children}, "card": card_name_power})
        start_o, start_a = origin.metrics(), agent.metrics()

        # (a) The canary alone: OPERATOR_PROBES good probes, recorded as
        # canary traffic, each one's pull on the card at both ends.
        probes = ProbeLog(agent.addr)
        good_sli = {"canary": "1", "result": "good", "sli": "pull"}
        t0 = time.perf_counter()
        while delta(start_a, agent.metrics(), "slo_events_total", **good_sli) < OPERATOR_PROBES:
            if time.perf_counter() - t0 > 60.0:
                raise AssertionError("operator: the canary recorded no "
                                     f"{OPERATOR_PROBES} good probes in 60 s: {probes.probes}"
                                     + agent.log()[-3000:])
            time.sleep(0.25)
        canary_s = time.perf_counter() - t0
        o_a, a_a = origin.metrics(), agent.metrics()
        alone = {"origin": launch_rise(start_o, o_a), "agent": launch_rise(start_a, a_a)}
        if not sum(alone["origin"].values()) or not sum(alone["agent"].values()):
            raise AssertionError(f"operator: a canary probe launched nothing: {alone}")
        alone_probes = [{"seq": p["seq"], "pull_s": p["stages"].get("pull_s"),
                         "upload_s": p["stages"].get("upload_s")} for p in probes.good()]
        emit({"phase": "operator", "leg": "a", "what": "canary alone",
              "probes_good": delta(start_a, a_a, "slo_events_total", **good_sli),
              "wall_s": canary_s, "probes": alone_probes, "launches": alone,
              "card": card_name_power})

        # (b) A user pull of 1 GiB, profiled through the agent's mux.
        blob = np.random.default_rng(SEED + 170).bytes(OPERATOR_BLOB)
        d = Digest.from_bytes(blob)
        url = f"http://{agent.addr}/namespace/{quote(OPERATOR_NS, safe='')}/blobs/{d.hex}"

        async def pull_under_profile() -> dict:
            client = BlobClient(origin.addr, HTTPClient(retries=0))
            try:
                t_up = time.perf_counter()
                await asyncio.wait_for(client.upload(OPERATOR_NS, d, blob,
                                                     chunk_size=ORIGIN_CHUNK), OPERATOR_TIMEOUT_S)
                upload_s = time.perf_counter() - t_up
            finally:
                await client.close()
            timeout = http_lite.ClientTimeout(total=OPERATOR_TIMEOUT_S)
            async with http_lite.ClientSession(timeout=timeout) as session:
                async def pull():
                    t = time.perf_counter()
                    async with session.get(url) as resp:
                        head = time.perf_counter() - t
                        body = await resp.read()
                    return resp.status, body, head, time.perf_counter() - t, t

                task = asyncio.ensure_future(pull())
                await asyncio.sleep(OPERATOR_PULL_LEAD_S)
                k0 = await asyncio.to_thread(agent.metrics)
                prof_url = f"http://{agent.addr}/debug/torch-profile?dir={quote(profile_dir)}"
                t_cap = time.perf_counter()
                capture = asyncio.ensure_future(
                    session.get(f"{prof_url}&seconds={OPERATOR_PROFILE_S}"))
                await asyncio.sleep(1.0)
                async with session.get(f"{prof_url}&seconds=1") as second:
                    second_status = second.status
                    await second.read()
                async with await capture as resp:
                    cap_status, cap_body = resp.status, await resp.read()
                cap_s = time.perf_counter() - t_cap
                k1 = await asyncio.to_thread(agent.metrics)
                status, body, head, wall, t_pull = await task
            return {"upload_s": upload_s, "status": status, "body": body, "head_s": head,
                    "pull_s": wall, "t_pull": t_pull, "k0": k0, "k1": k1,
                    "cap_status": cap_status, "cap_body": cap_body, "cap_s": cap_s,
                    "second_status": second_status, "t_cap": t_cap}

        t_pull0 = time.time()
        r = asyncio.run(pull_under_profile())
        t_pull1 = time.time()
        if r["status"] != 200 or r["body"] != blob:
            raise AssertionError(f"operator: the pull answered {r['status']} and is not "
                                 "byte-identical")
        if hashlib.sha256(r["body"]).hexdigest() != d.hex:
            raise AssertionError("operator: the pull's SHA-256 is not its digest")
        if r["cap_status"] != 200:
            raise AssertionError(f"operator: torch-profile answered {r['cap_status']}: "
                                 f"{r['cap_body'][:2000]!r}")
        cap = json.loads(r["cap_body"])
        rows_events = {k: v for k, v in cap["kernels"].items() if ROWS_KERNEL_NAME in k}
        rows_count = sum(rows_events.values())
        rows_busy_s = sum(v for k, v in cap["kernel_seconds"].items() if ROWS_KERNEL_NAME in k)
        # The card's busy share: the kernel's time over the window the
        # trace itself spans (its session event), not the answer's wall,
        # which adds the profiler's start and its stop and export.
        window_s = cap["trace_window_seconds"] or cap["traced_seconds"]
        busy_share = rows_busy_s / window_s
        rise = launch_rise(r["k0"], r["k1"])
        wrapper_rise = rise.get("sha256_ragged", 0.0) + rise.get("sha256_uniform", 0.0)
        if not rows_count:
            raise AssertionError(f"operator: the capture names no {ROWS_KERNEL_NAME}: "
                                 f"{cap['kernels']}")
        if rows_count > wrapper_rise:
            raise AssertionError(f"operator: the trace holds {rows_count} launches of "
                                 f"{ROWS_KERNEL_NAME}, the wrappers counted {wrapper_rise}")
        if r["second_status"] != 409:
            raise AssertionError(f"operator: a second capture answered {r['second_status']}")
        under = [{"seq": p["seq"], "pull_s": p["stages"].get("pull_s"),
                  "result": p["result"]} for p in probes.probes.values()
                 if t_pull0 <= p["ts"] <= t_pull1]
        trace_kb = os.path.getsize(cap["trace_file"]) / 1024
        emit({"phase": "operator", "leg": "b", "what": "1 GiB user pull under torch-profile",
              "blob_bytes": OPERATOR_BLOB, "upload_s": r["upload_s"], "pull_s": r["pull_s"],
              "swarm_pull_s": r["head_s"], "gbps": OPERATOR_BLOB / r["pull_s"] / 1e9,
              "capture_seconds": cap["seconds"], "capture_wall_s": cap["wall_seconds"],
              "traced_s": cap["traced_seconds"], "trace_window_s": cap["trace_window_seconds"],
              "capture_answer_s": r["cap_s"], "trace_kib": trace_kb,
              "rows_kernel_events": rows_count, "rows_kernel_busy_s": rows_busy_s,
              "busy_share": busy_share,
              "busy_share_of_wall": rows_busy_s / cap["wall_seconds"],
              "wrapper_launches_across_capture": rise, "kernels_in_trace": cap["kernels"],
              "canary_probes_during_pull": under, "second_capture_status": r["second_status"],
              "checks": ["pull byte-identical, SHA-256 = digest",
                         f"trace names {ROWS_KERNEL_NAME}",
                         "its events <= the wrappers' launches across the capture",
                         "a second capture during the first answered 409"],
              "card": card_name_power})

        # (c) The mux.
        for c in children:
            index = get_json(c.addr, "/debug/")
            missing = [p for p in MUX_ROUTES if p not in index["surfaces"]]
            if missing or "/debug/jax-profile" in index["surfaces"]:
                raise AssertionError(f"operator: {c.name}'s /debug/ lacks {missing}: {index}")
            if set(get_json(c.addr, "/debug/slo")) != SLO_KEYS:
                raise AssertionError(f"operator: {c.name}'s /debug/slo keys")
            if set(get_json(c.addr, "/debug/resources")) != RESOURCES_KEYS:
                raise AssertionError(f"operator: {c.name}'s /debug/resources keys")
            for name, snap in get_json(c.addr, "/debug/healthcheck").items():
                if snap.get("kind") == "breaker" and set(snap) != BREAKER_KEYS:
                    raise AssertionError(f"operator: {c.name}'s breaker {name}: {snap}")
        texts = {c.name: c.metrics() for c in children}
        blob_route = metric(texts["agent"], "http_requests_total", component="agent",
                            endpoint="/namespace/{ns}/blobs/{d}", method="GET", status="200")
        hex_labels = {n: _HEX64.findall(t) for n, t in texts.items() if _HEX64.findall(t)}
        if blob_route < 1 or hex_labels:
            raise AssertionError(f"operator: blob route count {blob_route}, digests in "
                                 f"labels {hex_labels}")
        series = sum(1 for t in texts.values() for line in t.splitlines()
                     if line.startswith("http_requests_total{"))
        emit({"phase": "operator", "leg": "c", "what": "the debug mux",
              "agent_blob_route_requests": blob_route, "http_requests_series": series,
              "surfaces": len(index["surfaces"]), "card": card_name_power})

        # (d) The tools, as an operator runs them.
        nodes = ",".join(c.addr for c in children)
        status_rc, status_out = cli_tool(["status", "--nodes", nodes])
        if status_rc != 0:
            raise AssertionError(f"operator: status exited {status_rc}:\n{status_out}")
        last = probes.good()[-1]
        dumps = []
        for c in children:
            spans = get_json(c.addr, f"/debug/trace?view=trace&trace_id={last['trace_id']}")
            path = os.path.join(root, f"trace-{c.name}.jsonl")
            with open(path, "w") as f:
                f.writelines(json.dumps(s) + "\n" for s in spans["spans"])
            dumps.append(path)
        trace_rc, trace_out = cli_tool(["trace", "--trace-id", last["trace_id"], *dumps])
        head = trace_out.splitlines()[0] if trace_out else ""
        if trace_rc != 0 or "nodes=agent,origin,tracker" not in head:
            raise AssertionError(f"operator: trace exited {trace_rc}:\n{trace_out[-3000:]}")
        prof = get_json(agent.addr, "/debug/pprof/profile?format=json")
        profile_path = os.path.join(root, "profile-agent.jsonl")
        with open(profile_path, "w") as f:
            f.write(json.dumps({"profile": "debug_pprof", "node": "agent",
                                "stacks": len(prof["stacks"]), "planes": prof["planes"]}) + "\n")
            f.writelines(json.dumps({"node": "agent", "stack": s, "count": n}) + "\n"
                         for s, n in prof["stacks"])
        flame_rc, flame_out = cli_tool(["flame", "--top", "5", profile_path])
        flame_done = json.loads(flame_out.strip().splitlines()[-1]) if flame_rc == 0 else {}
        if flame_rc != 0 or not flame_done.get("planes", {}).get("verify"):
            raise AssertionError(f"operator: flame exited {flame_rc}:\n{flame_out[-3000:]}")
        emit({"phase": "operator", "leg": "d", "what": "status, trace, flame",
              "status_exit": status_rc, "status": status_out.strip().splitlines()[-1],
              "trace_exit": trace_rc, "trace_head": head, "flame_exit": flame_rc,
              "flame_planes": flame_done["planes"],
              "flame_plane_pct_busy": flame_done["plane_pct_busy"], "card": card_name_power})

        # (e) Clean stops. The agent first, while the origin is up: its
        # stop reaps every canary blob it seeded, on both sides.
        async def origin_has(digests) -> list[str]:
            http = HTTPClient(retries=0)
            left = []
            try:
                for hx in digests:
                    try:
                        await http.get(f"http://{origin.addr}/namespace/kraken-canary/blobs/"
                                       f"{hx}/stat", retry_5xx=False)
                        left.append(hx)
                    except Exception:
                        pass
            finally:
                await http.close()
            return left

        probes.stop()
        end_o, end_a = origin.metrics(), agent.metrics()
        seeded = sorted({p["digest"] for p in probes.probes.values()})
        if not asyncio.run(origin_has(seeded)):
            raise AssertionError("operator: no canary blob seen on the origin before the stop")
        rcs = {"agent": agent.stop()}
        children.remove(agent)

        left_origin = asyncio.run(origin_has(seeded))
        with open(os.path.join(root, "agent", "canary-state.json")) as f:
            state_live = json.load(f)["live"]
        if rcs["agent"] != 0 or left_origin or state_live:
            raise AssertionError(f"operator: agent exit {rcs['agent']}, canary blobs left on "
                                 f"the origin {left_origin}, in the state {state_live}")
        rcs["origin"] = origin.stop()
        children.remove(origin)
        down_rc, down_out = cli_tool(["status", "--nodes", f"{tracker.addr},{origin.addr}"])
        summary = json.loads(down_out.strip().splitlines()[-1]) if down_out.strip() else {}
        if down_rc != 2 or summary.get("unreachable") != [origin.addr]:
            raise AssertionError(f"operator: status after the origin stopped exited "
                                 f"{down_rc}:\n{down_out}")
        rcs["tracker"] = tracker.stop()
        children.clear()
        if any(rcs.values()):
            raise AssertionError(f"operator: exit codes {rcs}")
        emit({"phase": "operator", "leg": "e", "what": "clean stops",
              "exit_codes": rcs, "canary_blobs_seeded": len(seeded),
              "canary_blobs_left_on_origin": len(left_origin),
              "status_after_origin_stop": summary, "card": card_name_power})
        phase = {"origin": launch_rise(start_o, end_o), "agent": launch_rise(start_a, end_a)}
        return {"ready_s": ready, "pull_s": r["pull_s"], "launches": phase,
                "busy_share": busy_share}
    finally:
        if probes is not None:
            probes.stop()
        for c in children:
            c.stop(kill=True)


# -- phase 18, shards: the multi-core data plane beside the card --------------
# Tracker, origin and two agents as CLI processes started together on ports
# picked beforehand, ``--hasher cuda``. The origin and agent A fork worker
# processes from a node whose CUDA context is live; agent B keeps the
# shipped 0 and one conn a torrent, so that it pulls from A alone once A
# holds pieces (the tracker hands out non-origin peers first).
SHARDS_NS = "library/shards"
SHARDS_BLOB = GiB
SHARDS_KILL_AT = 0.25  # of (b)'s pieces landed in A's leech workers
SHARDS_RESIZE_AT = 0.5  # of (b)'s pieces: the origin's SIGHUP, 2 workers to 1
SHARDS_TIMEOUT_S = 300.0
SHARDS_WAIT_S = 20.0  # for a stats tick, a respawn, a resize to show
SHARDS_ORIGIN = "scheduler:\n  data_plane_workers: {}\n"
SHARDS_A = "scheduler:\n  data_plane_workers: 2\n  leech_workers: 2\n"
SHARDS_B = "scheduler:\n  conn_state:\n    max_open_conns_per_torrent: 1\n"
SHARDS_KERNELS = ("sha256_uniform", "sha256_ragged", "pack_tiles_device",
                  "sha256_packed_tiles", "gear_candidates", "transpose_only")


def shard_sum(text: str, name: str, prefix: str) -> float:
    """The sum of ``name`` over the shards whose label starts with
    ``prefix`` (``data_plane_shard`` or ``leech_shard``)."""
    head = f'{name}{{shard="{prefix}'
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(head))


def worker_pids(pid: int) -> dict[str, int]:
    """The live worker processes of node ``pid``, by their process name
    (``kt-shard<n>``, ``kt-leech<n>``)."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        comm = stat[stat.index("(") + 1:stat.rindex(")")]
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == pid and comm.startswith("kt-") and state != "Z":
            out[comm] = int(entry)
    return out


def gone(pid: int) -> bool:
    """Has process ``pid`` exited (absent, or a zombie awaiting its reaper)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return True
    return stat[stat.rindex(")") + 2] == "Z"


def wait_metrics(child: "HerdChild", cond, what: str, timeout: float = SHARDS_WAIT_S) -> str:
    """Poll ``child``'s /metrics until ``cond(text)`` holds; the text."""
    t0 = time.perf_counter()
    while True:
        text = child.metrics()
        if cond(text):
            return text
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"shards: {what} within {timeout} s:\n" + child.log()[-3000:])
        time.sleep(0.2)


def require_shards_card_path(leg: str, got: dict) -> None:
    """The gates that read where the verify ran: on the card in each
    agent that pulled (no host batch, no hashlib byte), and the kernels of
    the path launched in each process."""
    for who in got["pulled_by"]:
        if got[f"{who}_host_batches"] or got[f"{who}_cpu_bytes"] or not got[f"{who}_cuda_batches"]:
            raise AssertionError(f"shards {leg}: {who} verified off the card: {got}")
        if not got["launches"][who]["sha256_ragged"]:
            raise AssertionError(f"shards {leg}: sha256_ragged did not launch at {who}: {got}")
    if got.get("uploaded") and not got["launches"]["origin"]["sha256_uniform"]:
        raise AssertionError(f"shards {leg}: sha256_uniform did not launch at the origin: {got}")


def verify_counts(before: str, after: str) -> dict:
    return {"cuda_batches": delta(before, after, "verify_batches_total", path="cuda"),
            "host_batches": delta(before, after, "verify_batches_total", path="host"),
            "pieces": delta(before, after, "verify_pieces_total"),
            "cuda_bytes": delta(before, after, "hasher_bytes_total", hasher="cuda"),
            "cpu_bytes": delta(before, after, "hasher_bytes_total", hasher="cpu")}


def shards_phase(root: str, card_name_power: str, herd_pull_s: float) -> dict:
    """Phase 18: pulls through forked seed-serve and leech workers beside
    a live CUDA context. Returns the numbers and the children's counters
    that the kernels line carries."""
    from kraken_tpu_torch import Digest
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.httputil import HTTPClient

    children: list[HerdChild] = []
    hasher = ["--hasher", HERD_HASHER]
    try:
        t_port, o_port = free_ports(2)
        t_addr, o_addr = f"127.0.0.1:{t_port}", f"127.0.0.1:{o_port}"
        o_cfg = herd_config(root, "origin", SHARDS_ORIGIN.format(2))
        specs = [
            ("tracker", "tracker", herd_config(root, "tracker"),
             ["--port", str(t_port), "--origins", o_addr]),
            ("origin", "origin", o_cfg, ["--port", str(o_port), "--tracker", t_addr, *hasher]),
            ("agent_a", "agent", herd_config(root, "agent", SHARDS_A, name="agent_a"),
             ["--tracker", t_addr, *hasher]),
            ("agent_b", "agent", herd_config(root, "agent", SHARDS_B, name="agent_b"),
             ["--tracker", t_addr, *hasher]),
        ]
        for name, component, cfg, flags in specs:
            children.append(HerdChild(root, name, [component, "--config", cfg, *flags],
                                      wait=False))
        for c in children:
            c.wait_ready()
        tracker, origin, agent_a, agent_b = children
        nodes = {"origin": origin, "agent_a": agent_a, "agent_b": agent_b}
        workers = {name: worker_pids(c.proc.pid) for name, c in nodes.items()}
        want = {"origin": {"kt-shard0", "kt-shard1"},
                "agent_a": {"kt-shard0", "kt-shard1", "kt-leech0", "kt-leech1"},
                "agent_b": set()}
        if {k: set(v) for k, v in workers.items()} != want:
            raise AssertionError(f"shards: workers {workers}, want {want}")
        emit({"phase": "shards", "ready_s": {c.name: c.ready_s for c in children},
              "addrs": {c.name: c.addr for c in children}, "workers": workers,
              "what": "four processes started together; the origin and agent A fork their "
                      "workers at start, after the CUDA context exists", "card": card_name_power})
        start = {name: c.metrics() for name, c in nodes.items()}
        pieces = SHARDS_BLOB // PIECE
        blob_url = f"/namespace/{quote(SHARDS_NS, safe='')}/blobs/"

        async def upload(blob: bytes, d) -> float:
            client = BlobClient(origin.addr, HTTPClient(retries=0))
            t0 = time.perf_counter()
            try:
                await asyncio.wait_for(client.upload(SHARDS_NS, d, blob, chunk_size=ORIGIN_CHUNK),
                                       SHARDS_TIMEOUT_S)
            finally:
                await client.close()
            return time.perf_counter() - t0

        async def pull(agent: HerdChild, d) -> dict:
            """GET through the agent's API: the response head marks the
            swarm pull's end, the body the serve."""
            timeout = http_lite.ClientTimeout(total=SHARDS_TIMEOUT_S)
            async with http_lite.ClientSession(timeout=timeout) as session:
                t0 = time.perf_counter()
                async with session.get(f"http://{agent.addr}{blob_url}{d.hex}") as resp:
                    head_s = time.perf_counter() - t0
                    got = await resp.read()
                pull_s = time.perf_counter() - t0
            if resp.status != 200:
                raise AssertionError(f"shards: GET on {agent.name} answered {resp.status}")
            return {"got": got, "pull_s": pull_s, "swarm_s": head_s, "serve_s": pull_s - head_s}

        def counters(before: dict, after: dict, pulled_by=(), uploaded=False) -> dict:
            got = {"pulled_by": list(pulled_by), "uploaded": uploaded,
                   "launches": {name: {k: delta(before[name], after[name],
                                                "kernel_launches_total", kernel=k)
                                       for k in SHARDS_KERNELS} for name in nodes}}
            for name in nodes:
                for k, v in verify_counts(before[name], after[name]).items():
                    got[f"{name}_{k}"] = v
            return got

        # (a) 1 GiB uploaded, then pulled through agent A's leech workers
        # from the origin's seed workers.
        rng = np.random.default_rng(SEED + 180)
        blob1 = rng.bytes(SHARDS_BLOB)
        d1 = Digest.from_bytes(blob1)
        m0 = {name: c.metrics() for name, c in nodes.items()}
        upload1_s = asyncio.run(upload(blob1, d1))
        m_up = {name: c.metrics() for name, c in nodes.items()}
        ra = asyncio.run(pull(agent_a, d1))
        if ra.pop("got") != blob1:
            raise AssertionError("shards (a): the blob through agent A is not byte-identical")
        a_text = wait_metrics(agent_a, lambda t: shard_sum(t, "data_plane_worker_pieces_total",
                                                           "leech_shard")
                              - shard_sum(m_up["agent_a"], "data_plane_worker_pieces_total",
                                          "leech_shard") >= pieces,
                              "A's leech workers counted fewer pieces than the blob's")
        o_text = wait_metrics(origin, lambda t: shard_sum(t, "data_plane_worker_bytes_sent_total",
                                                          "data_plane_shard")
                              - shard_sum(m_up["origin"], "data_plane_worker_bytes_sent_total",
                                          "data_plane_shard") >= SHARDS_BLOB,
                              "the origin's seed workers sent less than the blob")
        m1 = {"origin": o_text, "agent_a": a_text, "agent_b": agent_b.metrics()}
        got_a = counters(m0, m1, pulled_by=["agent_a"], uploaded=True)
        require_shards_card_path("a", got_a)
        ragged_a = delta(m_up["agent_a"], m1["agent_a"], "kernel_launches_total",
                         kernel="sha256_ragged")
        leg_a = {
            "upload_s": upload1_s, **ra, "gbps": SHARDS_BLOB / ra["pull_s"] / 1e9,
            "herd_pull_s": herd_pull_s,
            "origin_handoffs": delta(m0["origin"], m1["origin"], "data_plane_handoffs_total",
                                     shard="data_plane_shard0")
            + delta(m0["origin"], m1["origin"], "data_plane_handoffs_total",
                    shard="data_plane_shard1"),
            "origin_worker_bytes_sent": shard_sum(m1["origin"], "data_plane_worker_bytes_sent_total",
                                                  "data_plane_shard")
            - shard_sum(m0["origin"], "data_plane_worker_bytes_sent_total", "data_plane_shard"),
            "a_leech_pieces": shard_sum(m1["agent_a"], "data_plane_worker_pieces_total",
                                        "leech_shard")
            - shard_sum(m_up["agent_a"], "data_plane_worker_pieces_total", "leech_shard"),
            "a_verified_pieces": got_a["agent_a_pieces"],
            "a_ragged_launches": ragged_a,
            "a_rows_per_launch": got_a["agent_a_pieces"] / ragged_a if ragged_a else None,
            "launches": got_a["launches"],
        }
        if leg_a["origin_handoffs"] < 1:
            raise AssertionError(f"shards (a): the origin handed no conn to a worker: {leg_a}")
        emit({"phase": "shards", "leg": "a", "blob_bytes": SHARDS_BLOB, "pieces": pieces,
              **leg_a, "checks": ["blob byte-identical through agent A",
                                  "every piece landed in A's leech workers' rings",
                                  "the origin's seed workers sent the whole blob",
                                  "every verify batch at A on the card"],
              "card": card_name_power})

        # (b) A fresh 1 GiB: A pulls it, B pulls it from A; A's leech worker
        # holding a conn is SIGKILLed at SHARDS_KILL_AT of the pieces, and
        # (d) the origin is resized from 2 workers to 1 at SHARDS_RESIZE_AT.
        blob2 = rng.bytes(SHARDS_BLOB)
        d2 = Digest.from_bytes(blob2)
        m2_up = {name: c.metrics() for name, c in nodes.items()}
        upload2_s = asyncio.run(upload(blob2, d2))
        m2 = {name: c.metrics() for name, c in nodes.items()}
        base_pieces = shard_sum(m2["agent_a"], "data_plane_worker_pieces_total", "leech_shard")
        marks: dict = {}

        def landed(text: str) -> float:
            return shard_sum(text, "data_plane_worker_pieces_total", "leech_shard") - base_pieces

        def chaos() -> None:
            """Runs beside the pulls: start B once A holds pieces, kill the
            leech worker, resize the origin."""
            try:
                wait_metrics(agent_a, lambda t: landed(t) >= 8, "A landed no piece of (b)",
                             SHARDS_TIMEOUT_S)
            finally:
                marks["b_start"] = time.perf_counter()
                marks["b_go"].set()
            # Both leech workers hold a conn (the origin's, B's), so that
            # the peer of the killed one redials onto the respawn, the
            # least loaded.
            text = wait_metrics(
                agent_a, lambda t: landed(t) >= SHARDS_KILL_AT * pieces and all(
                    metric(t, "data_plane_worker_conns", shard=f"leech_shard{n}") >= 1
                    for n in (0, 1)),
                "A's two leech workers never both held a conn", SHARDS_TIMEOUT_S)
            shard = max((0, 1), key=lambda n: metric(text, "data_plane_worker_conns",
                                                     shard=f"leech_shard{n}"))
            pid = worker_pids(agent_a.proc.pid)[f"kt-leech{shard}"]
            marks.update(killed_shard=shard, killed_pid=pid, kill_at_pieces=landed(text),
                         before_kill=text)
            os.kill(pid, signal.SIGKILL)
            marks["kill_t"] = time.perf_counter()
            t0 = time.perf_counter()
            while worker_pids(agent_a.proc.pid).get(f"kt-leech{shard}") in (None, pid):
                if time.perf_counter() - t0 > SHARDS_WAIT_S:
                    raise AssertionError("shards (b): the killed leech worker was not respawned")
                time.sleep(0.05)
            marks["respawn_s"] = time.perf_counter() - marks["kill_t"]
            text = wait_metrics(agent_a, lambda t: landed(t) >= SHARDS_RESIZE_AT * pieces,
                                "A stalled after the kill", SHARDS_TIMEOUT_S)
            marks["before_resize"] = origin.metrics()
            herd_config(root, "origin", SHARDS_ORIGIN.format(1))
            origin.proc.send_signal(signal.SIGHUP)
            marks["resize_t"] = time.perf_counter()

        async def legs_b() -> dict:
            marks["b_go"] = threading.Event()
            marks["t0"] = time.perf_counter()
            side = asyncio.create_task(asyncio.to_thread(chaos))
            a_task = asyncio.create_task(pull(agent_a, d2))
            await asyncio.to_thread(marks["b_go"].wait, SHARDS_TIMEOUT_S)
            b_task = asyncio.create_task(pull(agent_b, d2))
            try:
                await side
            finally:
                ra_, rb_ = await asyncio.gather(a_task, b_task)
            return {"a": ra_, "b": rb_}

        rb = asyncio.run(legs_b())
        for who, r in rb.items():
            if r.pop("got") != blob2:
                raise AssertionError(f"shards (b): the blob through agent {who.upper()} "
                                     "is not byte-identical")
        shard = marks["killed_shard"]
        label = f"leech_shard{shard}"
        m3 = {name: c.metrics() for name, c in nodes.items()}
        a_crashes = {n: delta(m2["agent_a"], m3["agent_a"], "data_plane_worker_crashes_total",
                              shard=s) for n, s in (("leech0", "leech_shard0"),
                                                   ("leech1", "leech_shard1"),
                                                   ("shard0", "data_plane_shard0"),
                                                   ("shard1", "data_plane_shard1"))}
        respawn_handoffs = delta(marks["before_kill"], m3["agent_a"],
                                 "data_plane_handoffs_total", shard=label)
        closes = {r: delta(m2["agent_a"], m3["agent_a"], "conn_closed_total", reason=r)
                  for r in ("worker_exit", "misbehavior")}
        origin_crashes = delta(m2["origin"], m3["origin"], "data_plane_worker_crashes_total",
                               shard="data_plane_shard0") + delta(
            m2["origin"], m3["origin"], "data_plane_worker_crashes_total",
            shard="data_plane_shard1")
        want_crashes = {k: int(k == f"leech{shard}") for k in a_crashes}
        if a_crashes != want_crashes or origin_crashes:
            raise AssertionError(f"shards (b): crashes {a_crashes} (origin {origin_crashes}), "
                                 f"want {want_crashes}")
        if respawn_handoffs < 1:
            raise AssertionError(f"shards (b): the respawned {label} took no conn")
        if closes["worker_exit"] < 1 or closes["misbehavior"]:
            raise AssertionError(f"shards (b): conn closes at A {closes}: the dead worker's "
                                 "conns must close as the node's fault, none as a peer's")
        got_b = counters(m2_up, m3, pulled_by=["agent_a", "agent_b"], uploaded=True)
        require_shards_card_path("b", got_b)
        emit({"phase": "shards", "leg": "b", "blob_bytes": SHARDS_BLOB, "upload_s": upload2_s,
              "a": rb["a"], "b": rb["b"], "b_started_after_s": marks["b_start"] - marks["t0"],
              "killed_after_s": marks["kill_t"] - marks["t0"],
              "killed": {"shard": label, "pid": marks["killed_pid"],
                         "at_pieces": marks["kill_at_pieces"]},
              "respawn_s": marks["respawn_s"], "respawn_handoffs": respawn_handoffs,
              "crashes": a_crashes, "conn_closes": closes, "launches": got_b["launches"],
              "a_verified_pieces": got_b["agent_a_pieces"],
              "b_verified_pieces": got_b["agent_b_pieces"],
              "checks": ["both pulls byte-identical",
                         f"data_plane_worker_crashes_total{{shard={label}}} +1, no other",
                         "the killed worker's conns closed as worker_exit, none as misbehavior",
                         f"the respawned {label} took a conn",
                         "every verify batch at A and B on the card"],
              "card": card_name_power})

        # (d) The origin's resize, applied during (b): the gauge reads 1,
        # one worker is left, and the serves it had in flight finished
        # (both pulls are whole).
        o_text = wait_metrics(origin, lambda t: metric(t, "data_plane_workers",
                                                       component="origin") == 1
                              and metric(t, "data_plane_workers_alive", component="origin") == 1,
                              "the origin's resize to 1 did not show")
        left = worker_pids(origin.proc.pid)
        if set(left) != {"kt-shard0"} or '"data_plane_workers": 1' not in origin.log():
            raise AssertionError(f"shards (d): the origin's workers after the resize: {left}")
        if "exited non-zero" in origin.log():
            raise AssertionError("shards (d): the retired worker exited non-zero:\n"
                                 + origin.log()[-3000:])
        before = marks["before_resize"]
        emit({"phase": "shards", "leg": "d", "what": "SIGHUP data_plane_workers 2 -> 1 at the "
              "origin while (b) pulled",
              "applied_after_s": marks["resize_t"] - marks["kill_t"],
              "workers_gauge": metric(o_text, "data_plane_workers", component="origin"),
              "alive_gauge": metric(o_text, "data_plane_workers_alive", component="origin"),
              "conns_before": {s: metric(before, "data_plane_worker_conns", shard=s)
                               for s in ("data_plane_shard0", "data_plane_shard1")},
              "serves_after": shard_sum(o_text, "data_plane_worker_serves_total",
                                        "data_plane_shard")
              - shard_sum(before, "data_plane_worker_serves_total", "data_plane_shard"),
              "workers_left": left, "card": card_name_power})

        # (c) B pulls (a)'s blob: its one conn goes to A, which serves it
        # from a seed worker through sendfile.
        m4 = {name: c.metrics() for name, c in nodes.items()}
        rc = asyncio.run(pull(agent_b, d1))
        if rc.pop("got") != blob1:
            raise AssertionError("shards (c): the blob through agent B is not byte-identical")
        a_text = wait_metrics(agent_a, lambda t: shard_sum(t, "data_plane_worker_bytes_sent_total",
                                                           "data_plane_shard")
                              - shard_sum(m4["agent_a"], "data_plane_worker_bytes_sent_total",
                                          "data_plane_shard") >= SHARDS_BLOB,
                              "A's seed workers sent less than the blob")
        m5 = {"origin": origin.metrics(), "agent_a": a_text, "agent_b": agent_b.metrics()}
        got_c = counters(m4, m5, pulled_by=["agent_b"])
        require_shards_card_path("c", got_c)
        sent = {s: delta(m4["agent_a"], m5["agent_a"], "data_plane_worker_bytes_sent_total",
                         shard=s) for s in ("data_plane_shard0", "data_plane_shard1")}
        origin_sent = shard_sum(m5["origin"], "data_plane_worker_bytes_sent_total",
                                "data_plane_shard") - shard_sum(
            m4["origin"], "data_plane_worker_bytes_sent_total", "data_plane_shard")
        emit({"phase": "shards", "leg": "c", "blob_bytes": SHARDS_BLOB, **rc,
              "gbps": SHARDS_BLOB / rc["pull_s"] / 1e9, "a_seed_bytes_sent": sent,
              "origin_bytes_sent": origin_sent, "b_verified_pieces": got_c["agent_b_pieces"],
              "launches": got_c["launches"],
              "checks": ["blob byte-identical through agent B",
                         "A's seed workers sent the whole blob by sendfile"],
              "card": card_name_power})
        end = m5

        # (e) SIGTERM: every child exits 0 after its drain, and no worker
        # outlives its node.
        pids = {name: worker_pids(c.proc.pid) for name, c in nodes.items()}
        drains = {}
        for c, component in ((agent_b, "agent"), (agent_a, "agent"), (origin, "origin"),
                             (tracker, "tracker")):
            cfg = load_config(str(REPO / "config" / component / "base.yaml"))
            limit = RPCConfig.from_dict(cfg.get("rpc")).drain_timeout_seconds
            t0 = time.perf_counter()
            rc_ = c.stop()
            drains[c.name] = time.perf_counter() - t0
            if rc_ != 0 or drains[c.name] > limit or "drain quiesced" not in c.log():
                raise AssertionError(f"shards (e): {c.name} exit {rc_} after "
                                     f"{drains[c.name]:.1f} s:\n" + c.log()[-3000:])
            if "exited non-zero" in c.log():
                raise AssertionError(f"shards (e): a worker of {c.name} exited non-zero:\n"
                                     + c.log()[-3000:])
        children.clear()
        t0 = time.perf_counter()
        left = {}
        while True:
            left = {name: [p for p in ps.values() if not gone(p)] for name, ps in pids.items()}
            if not any(left.values()) or time.perf_counter() - t0 > 10.0:
                break
            time.sleep(0.1)
        if any(left.values()):
            raise AssertionError(f"shards (e): workers outlived their nodes: {left}")
        emit({"phase": "shards", "leg": "e", "drain_to_exit_s": drains, "workers_reaped": pids,
              "card": card_name_power})
        launches = {name: {k: delta(start[name], end[name], "kernel_launches_total", kernel=k)
                           for k in SHARDS_KERNELS} for name in nodes}
        return {"launches": launches, "pull_a_s": ra["pull_s"], "pull_c_s": rc["pull_s"],
                "rows_per_launch": leg_a["a_rows_per_launch"]}
    finally:
        for c in children:
            c.stop(kill=True)


# -- phase 19, the remote backends and the offline tools ------------------------
# An origin as kraken deploys one, a cache in front of blob storage: its
# ``backends:`` maps ``^s3/.*`` to ``s3`` (a fake S3) and ``^library/.*`` to
# ``registry_blob`` (a fake upstream docker registry, as a cluster fronting
# Docker Hub has it); a build-index resolves tags through ``registry_tag`` at
# the same upstream. Tracker, origin, build-index and agent (with its registry
# endpoint) as four CLI processes started together, ``--hasher cuda``. The two
# fakes run in this process on the port's ``http_lite``.
BACKENDS_NS = "s3/blobs"
BACKENDS_BLOB = GiB
BACKENDS_PART = 64 * MiB  # the S3 client's shipped multipart threshold and part size
BACKENDS_REPO = "library/ubuntu"
BACKENDS_TAG = "22.04"
BACKENDS_TIMEOUT_S = 300.0
BACKENDS_KERNELS = SHARDS_KERNELS  # every wrapper, to show which ran
S3_BUCKET = "kraken"
S3_KEYS = {"access_key": "AKIAKRAKENSMOKE", "secret_key": "smoke/secret+key", "region": "us-east-1"}
UPSTREAM_TOKEN = "smoke-token-0"
UPSTREAM_SERVICE = "smoke-registry"
S3_WRITE = 4 * MiB  # the fake's GET writes


class RemoteFakes:
    """A fake S3 and a fake upstream docker registry, served by ``http_lite``
    on a loop in a thread of this process:

    - S3 re-derives every request's SigV4 signature with the port's
      ``sigv4_headers`` at the client's stated time, holds the body's
      SHA-256 to ``x-amz-content-sha256`` (a mismatch answers 403 and is
      kept in ``bad``), and counts multipart initiations, parts,
      completions and aborts; a GET streams the object in 4 MiB writes,
      its first and last byte marked; an object's completion is marked.
    - The upstream answers a request without its token with 401 and a
      ``Bearer realm=`` challenge, issues the token at ``/token``, serves
      a manifest by tag or digest with ``Docker-Content-Digest``, and
      answers each blob GET with a 307 to a second listener that stands in
      for a presigned store URL; that listener records whether an
      ``Authorization`` header arrived, and refuses one (400) as S3 does.

    ``busy_s`` sums the S3 handlers' own work (signature checks and body
    hashes, part joins): the fakes' share of a wall measured around them."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}
        self.uploads: dict[str, dict[int, bytes]] = {}
        self.parts: list[int] = []
        self.initiated = self.completed = self.aborted = 0
        self.completed_at: dict[str, float] = {}
        self.gets: dict[str, list[tuple[float, float]]] = {}
        self.bad: list[str] = []
        self.busy_s = 0.0
        self.upstream: dict[str, bytes] = {}  # "repo/sha256:hex" -> bytes
        self.tags: dict[str, bytes] = {}  # "repo:tag" -> manifest
        self.token_fetches = self.challenges = 0
        self.blob_gets: list[str] = []
        self.manifest_gets: list[str] = []
        self.presigned_auth: list[str | None] = []
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        self._runners: list = []
        self.s3_addr, self.upstream_addr, self.store_addr = self._call(self._start())

    def _call(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def _start(self) -> list[str]:
        from kraken_tpu_torch.utils import http_lite as web

        s3 = web.Application(client_max_size=2 * BACKENDS_PART)
        s3.router.add_route("*", "/{path:.*}", self._s3)
        up = web.Application()
        up.router.add_get("/token", self._token)
        up.router.add_route("*", "/v2/{repo:.+}/blobs/{digest}", self._blob)
        up.router.add_route("*", "/v2/{repo:.+}/manifests/{ref}", self._manifest)
        store = web.Application()
        store.router.add_get("/presigned/{key:.+}", self._presigned)
        addrs = []
        for app in (s3, up, store):
            runner, port = await web.serve(app, "127.0.0.1", 0)
            self._runners.append(runner)
            addrs.append(f"127.0.0.1:{port}")
        return addrs

    def close(self) -> None:
        async def stop():
            for runner in self._runners:
                await runner.cleanup()

        try:
            self._call(stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(10)
            self.loop.close()

    # -- S3 ------------------------------------------------------------------

    def _check_sigv4(self, req, body: bytes) -> str | None:
        import datetime
        from urllib.parse import urlencode

        from kraken_tpu_torch.backend.s3backend import sigv4_headers

        sha = req.headers.get("x-amz-content-sha256", "")
        if sha != hashlib.sha256(body).hexdigest():
            return f"{req.method} {req.raw_path}: payload SHA-256 != x-amz-content-sha256"
        try:
            now = datetime.datetime.strptime(req.headers["x-amz-date"], "%Y%m%dT%H%M%SZ")
        except (KeyError, ValueError):
            return f"{req.method} {req.raw_path}: no x-amz-date"
        query = urlencode(list(req.query.items()))
        url = f"http://{req.headers.get('Host', '')}{req.raw_path}" + (f"?{query}" if query else "")
        want = sigv4_headers(req.method, url, payload_sha256=sha,
                             now=now.replace(tzinfo=datetime.timezone.utc), **S3_KEYS)
        if req.headers.get("Authorization") != want["Authorization"]:
            return f"{req.method} {req.raw_path}: signature mismatch"
        return None

    async def _s3(self, req):
        from kraken_tpu_torch.utils import http_lite as web

        body = await req.read()
        t0 = time.perf_counter()
        bad = self._check_sigv4(req, body)
        self.busy_s += time.perf_counter() - t0
        if bad:
            self.bad.append(bad)
            return web.Response(status=403, text=bad)
        _bucket, _, key = req.path.lstrip("/").partition("/")
        q = req.query
        if req.method == "POST" and "uploads" in q:
            uid = f"mpu-{self.initiated}"
            self.initiated += 1
            self.uploads[uid] = {}
            return web.Response(text=f"<InitiateMultipartUploadResult><UploadId>{uid}"
                                     "</UploadId></InitiateMultipartUploadResult>",
                                content_type="application/xml")
        if req.method == "PUT" and "partNumber" in q:
            parts = self.uploads.get(q.get("uploadId", ""))
            if parts is None:
                return web.Response(status=404)
            n = int(q["partNumber"])
            parts[n] = body
            self.parts.append(len(body))
            return web.Response(headers={"ETag": f'"{n}-{len(body)}"'})
        if req.method == "POST" and "uploadId" in q:
            parts = self.uploads.pop(q["uploadId"], None)
            if parts is None:
                return web.Response(status=404)
            doc = body.decode()
            nums = [int(m) for m in re.findall(r"<PartNumber>(\d+)</PartNumber>", doc)]
            etags = re.findall(r"<ETag>([^<]*)</ETag>", doc)
            if nums != sorted(parts) or etags != [f"{n}-{len(parts[n])}" for n in nums]:
                return web.Response(status=400, text="InvalidPart")
            t0 = time.perf_counter()
            self.objects[key] = b"".join(parts[n] for n in nums)
            self.busy_s += time.perf_counter() - t0
            self.completed += 1
            self.completed_at[key] = time.perf_counter()
            return web.Response(text=f"<CompleteMultipartUploadResult><Key>{key}</Key>"
                                     "</CompleteMultipartUploadResult>",
                                content_type="application/xml")
        if req.method == "DELETE" and "uploadId" in q:
            self.uploads.pop(q["uploadId"], None)
            self.aborted += 1
            return web.Response(status=204)
        if req.method == "PUT":
            self.objects[key] = body
            self.completed_at[key] = time.perf_counter()
            return web.Response(status=200)
        data = self.objects.get(key)
        if data is None:
            return web.Response(status=404)
        if req.method == "HEAD":
            return web.Response(headers={"Content-Length": str(len(data))})
        t0 = time.perf_counter()
        resp = web.StreamResponse()
        resp.content_length = len(data)
        await resp.prepare(req)
        view = memoryview(data)
        for off in range(0, len(data), S3_WRITE):
            await resp.write(view[off:off + S3_WRITE])
        await resp.write_eof()
        self.gets.setdefault(key, []).append((t0, time.perf_counter()))
        return resp

    # -- the upstream registry -------------------------------------------------

    def _denied(self, req, repo: str):
        from kraken_tpu_torch.utils import http_lite as web

        if req.headers.get("Authorization") == f"Bearer {UPSTREAM_TOKEN}":
            return None
        self.challenges += 1
        return web.Response(status=401, headers={"WWW-Authenticate": (
            f'Bearer realm="http://{self.upstream_addr}/token",service="{UPSTREAM_SERVICE}",'
            f'scope="repository:{repo}:pull"')})

    async def _token(self, req):
        from kraken_tpu_torch.utils import http_lite as web

        if (req.query.get("service") != UPSTREAM_SERVICE
                or not req.query.get("scope", "").startswith("repository:")):
            return web.Response(status=400)
        self.token_fetches += 1
        return web.json_response({"token": UPSTREAM_TOKEN, "expires_in": 300})

    async def _blob(self, req):
        from kraken_tpu_torch.utils import http_lite as web

        repo, digest = req.match_info["repo"], req.match_info["digest"]
        denied = self._denied(req, repo)
        if denied is not None:
            return denied
        data = self.upstream.get(f"{repo}/{digest}")
        if data is None:
            return web.Response(status=404)
        if req.method == "HEAD":
            return web.Response(headers={"Content-Length": str(len(data))})
        self.blob_gets.append(f"{repo}/{digest}")
        return web.Response(status=307, headers={
            "Location": f"http://{self.store_addr}/presigned/{repo}/{digest}"
                        "?X-Amz-Signature=smoke"})

    async def _manifest(self, req):
        from kraken_tpu_torch.utils import http_lite as web

        repo, ref = req.match_info["repo"], req.match_info["ref"]
        denied = self._denied(req, repo)
        if denied is not None:
            return denied
        data = self.tags.get(f"{repo}:{ref}") or self.upstream.get(f"{repo}/{ref}")
        if data is None:
            return web.Response(status=404)
        self.manifest_gets.append(f"{repo}:{ref}")
        return web.Response(body=data, headers={
            "Docker-Content-Digest": "sha256:" + hashlib.sha256(data).hexdigest(),
            "Content-Type": DOCKER2})

    async def _presigned(self, req):
        from kraken_tpu_torch.utils import http_lite as web

        auth = req.headers.get("Authorization")
        self.presigned_auth.append(auth)
        if auth is not None:
            return web.Response(status=400, text="OnlyOneAuthMechanismAllowed")
        data = self.upstream.get(req.match_info["key"])
        if data is None:
            return web.Response(status=404)
        return web.Response(body=data)


def backends_image() -> tuple[list[bytes], bytes]:
    """``library/ubuntu:22.04`` upstream: a config blob and one layer at
    BASELINE.json config 2's ``ubuntu:22.04`` size, seeded, and its schema2
    manifest."""
    from kraken_tpu_torch import Digest

    layer = np.random.default_rng(SEED + 90).bytes(dict(SWARM_LAYERS)["ubuntu"])
    config = json.dumps({"architecture": "amd64", "os": "linux", "rootfs": {
        "type": "layers", "diff_ids": [str(Digest.from_bytes(layer))]}}).encode()
    manifest = json.dumps({
        "schemaVersion": 2, "mediaType": DOCKER2,
        "config": {"mediaType": "application/vnd.docker.container.image.v1+json",
                   "size": len(config), "digest": str(Digest.from_bytes(config))},
        "layers": [{"mediaType": "application/vnd.docker.image.rootfs.diff.tar.gzip",
                    "size": len(layer), "digest": str(Digest.from_bytes(layer))}],
    }).encode()
    return [config, layer], manifest


def card_only(leg: str, got: dict, origin_pieces: int) -> None:
    """The origin's piece hashes and the agent's verify all on the card, and
    the path's kernels launched at each."""
    if (got["origin_cpu_pieces"] or got["origin_cuda_pieces"] < origin_pieces
            or got["origin_fallbacks"]):
        raise AssertionError(f"backends ({leg}): origin piece hashing off the card: {got}")
    if got["agent_cuda_batches"] < 1 or got["agent_host_batches"] or got["agent_cpu_bytes"]:
        raise AssertionError(f"backends ({leg}): agent verify off the card: {got}")
    if not got["origin_launches"]["sha256_uniform"] or not got["agent_launches"]["sha256_ragged"]:
        raise AssertionError(f"backends ({leg}): a kernel of the path did not launch: {got}")


def _timed_sha256(data) -> float:
    """hashlib's SHA-256 of ``data``, timed: what the S3 client pays a part
    for its SigV4 payload hash."""
    t0 = time.perf_counter()
    hashlib.sha256(data).digest()
    return time.perf_counter() - t0


def backends_phase(root: str, card_name_power: str) -> dict:
    """Phase 19: writeback to S3, a cold 1 GiB pull refreshed from S3, an
    image pulled through the upstream registry by tag, the offline tools on
    the stopped nodes' stores. Returns the children's counters that the
    kernels line carries."""
    from kraken_tpu_torch import Digest, MetaInfo
    from kraken_tpu_torch.backend.namepath import get_pather
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.origin.metainfogen import PieceLengthConfig
    from kraken_tpu_torch.utils import http_lite
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.httputil import HTTPClient

    fakes = RemoteFakes()
    children: list[HerdChild] = []
    hasher = ["--hasher", HERD_HASHER]
    try:
        s3 = ", ".join(f"{k}: {json.dumps(v)}" for k, v in {
            "endpoint": f"http://{fakes.s3_addr}", "bucket": S3_BUCKET, **S3_KEYS}.items())
        origin_backends = (
            "backends:\n"
            f'  - namespace: "^s3/.*"\n    backend: s3\n    config: {{{s3}}}\n'
            f'  - namespace: "^library/.*"\n    backend: registry_blob\n'
            f'    config: {{address: "{fakes.upstream_addr}"}}\n')
        tag_backends = ("backends:\n"
                        f'  - namespace: ".*"\n    backend: registry_tag\n'
                        f'    config: {{address: "{fakes.upstream_addr}"}}\n')
        t_port, o_port, b_port = free_ports(3)
        t_addr, o_addr, b_addr = (f"127.0.0.1:{p}" for p in (t_port, o_port, b_port))
        specs = [
            ("tracker", herd_config(root, "tracker"), ["--port", str(t_port), "--origins", o_addr]),
            ("origin", herd_config(root, "origin", backends=origin_backends),
             ["--port", str(o_port), "--tracker", t_addr, *hasher]),
            ("build-index", herd_config(root, "build-index", backends=tag_backends),
             ["--port", str(b_port), "--origins", o_addr]),
            ("agent", herd_config(root, "agent", "registry_port: 0\n"),
             ["--tracker", t_addr, "--build-index", b_addr, *hasher]),
        ]
        for name, cfg, flags in specs:
            children.append(HerdChild(root, name, [name, "--config", cfg, *flags], wait=False))
        for c in children:
            c.wait_ready()
        tracker, origin, bindex, agent = children
        registry = agent.ready.get("registry_addr")
        if not registry:
            raise AssertionError(f"backends: the agent reported no registry: {agent.ready}")
        ready = {c.name: c.ready_s for c in children}
        emit({"phase": "backends", "ready_s": ready,
              "addrs": {**{c.name: c.addr for c in children}, "agent_registry": registry,
                        "fake_s3": fakes.s3_addr, "fake_upstream": fakes.upstream_addr,
                        "fake_presigned_store": fakes.store_addr},
              "what": "four processes started together; the origin's backends: s3 and "
                      "registry_blob, the build-index's: registry_tag", "card": card_name_power})
        pather = get_pather("sharded_docker_blob")
        lengths = PieceLengthConfig()
        timeout = http_lite.ClientTimeout(total=BACKENDS_TIMEOUT_S)

        def counters(o0: str, o1: str, a0: str, a1: str) -> dict:
            return {
                "origin_cuda_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cuda"),
                "origin_cpu_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cpu"),
                "origin_fallbacks": delta(o0, o1, "ingest_fallbacks_total"),
                "origin_dedup_chunks": delta(o0, o1, "origin_dedup_unique_chunks"),
                "origin_refresh_pulls": delta(o0, o1, "blob_refresh_pulls_total", result="ok"),
                "agent_cuda_batches": delta(a0, a1, "verify_batches_total", path="cuda"),
                "agent_host_batches": delta(a0, a1, "verify_batches_total", path="host"),
                "agent_verified_pieces": delta(a0, a1, "verify_pieces_total"),
                "agent_cuda_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cuda"),
                "agent_cpu_bytes": delta(a0, a1, "hasher_bytes_total", hasher="cpu"),
                "origin_launches": {k: delta(o0, o1, "kernel_launches_total", kernel=k)
                                    for k in BACKENDS_KERNELS},
                "agent_launches": {k: delta(a0, a1, "kernel_launches_total", kernel=k)
                                   for k in BACKENDS_KERNELS},
            }

        def dedup_done(o0: str, blobs: int) -> str:
            """The origin's metrics once its dedup pass has indexed ``blobs``
            more blobs (every counter then holds the whole path)."""
            o1 = origin.metrics()
            deadline = time.perf_counter() + BACKENDS_TIMEOUT_S
            while (metric(o1, "origin_dedup_indexed_blobs")
                   - metric(o0, "origin_dedup_indexed_blobs") < blobs):
                if time.perf_counter() > deadline:
                    raise AssertionError("backends: the origin's dedup pass did not finish")
                time.sleep(0.5)
                o1 = origin.metrics()
            return o1

        # (a) Writeback: 1 GiB committed under s3/..., written back by the
        # origin's retry plane through S3's multipart upload.
        blob_a = np.random.default_rng(SEED + 91).bytes(BACKENDS_BLOB)
        d_a = Digest.from_bytes(blob_a)
        key_a = pather("", d_a.hex)
        o0 = origin.metrics()

        async def upload() -> float:
            client = BlobClient(origin.addr, HTTPClient(retries=0))
            try:
                await asyncio.wait_for(client.upload(BACKENDS_NS, d_a, blob_a,
                                                     chunk_size=ORIGIN_CHUNK), BACKENDS_TIMEOUT_S)
            finally:
                await client.close()
            return time.perf_counter()

        t0 = time.perf_counter()
        acked = asyncio.run(upload())
        deadline = acked + BACKENDS_TIMEOUT_S
        while key_a not in fakes.completed_at:
            if time.perf_counter() > deadline or fakes.aborted:
                raise AssertionError(f"backends (a): no writeback; initiated {fakes.initiated}, "
                                     f"parts {len(fakes.parts)}, aborted {fakes.aborted}, "
                                     f"bad {fakes.bad[:3]}")
            time.sleep(0.01)
        landed = fakes.completed_at[key_a]
        o1 = dedup_done(o0, 1)
        sigv4_hash_s = sum(_timed_sha256(memoryview(blob_a)[off:off + BACKENDS_PART])
                           for off in range(0, BACKENDS_BLOB, BACKENDS_PART))
        got_a = {"initiated": fakes.initiated, "completed": fakes.completed,
                 "aborted": fakes.aborted, "parts": len(fakes.parts),
                 "part_bytes": sorted(set(fakes.parts)), "bad_requests": len(fakes.bad)}
        want_a = {"initiated": 1, "completed": 1, "aborted": 0,
                  "parts": BACKENDS_BLOB // BACKENDS_PART, "part_bytes": [BACKENDS_PART],
                  "bad_requests": 0}
        if got_a != want_a:
            raise AssertionError(f"backends (a): multipart {got_a}, want {want_a}")
        if hashlib.sha256(fakes.objects[key_a]).hexdigest() != d_a.hex:
            raise AssertionError("backends (a): the object's SHA-256 is not its digest")
        emit({"phase": "backends", "leg": "a_writeback", "blob_bytes": BACKENDS_BLOB,
              "upload_to_201_s": acked - t0, "writeback_s": landed - acked,
              "writeback_gbps": BACKENDS_BLOB / (landed - acked) / 1e9,
              "fake_busy_s": fakes.busy_s, "sigv4_hashlib_s": sigv4_hash_s,
              **got_a, "origin_launches": launch_rise(o0, o1),
              "what": "writeback_s: from the origin's 201 to the fake's CompleteMultipartUpload "
                      "(the retry plane's pick-up, the signed 64 MiB part PUTs, the complete); "
                      "fake_busy_s: the fake's own signature and body checks within it; "
                      "sigv4_hashlib_s: hashlib over the parts in this process, the client's "
                      "payload hashes for SigV4 at this host's rate",
              "checks": [f"{want_a['parts']} parts of 64 MiB, every request's SigV4 re-derived "
                         "by the fake",
                         "initiated 1, completed 1, aborted 0",
                         "the object's SHA-256 = its digest"], "card": card_name_power})

        # (b) The cold refresh: a fresh 1 GiB only in S3; the agent GETs it
        # by digest, the origin refreshes on the miss (S3 GET, commit,
        # metainfo on the card), then the swarm, then the serve.
        blob_b = np.random.default_rng(SEED + 92).bytes(BACKENDS_BLOB)
        d_b = Digest.from_bytes(blob_b)
        key_b = pather("", d_b.hex)
        fakes.objects[key_b] = blob_b
        pieces_b = -(-BACKENDS_BLOB // lengths.piece_length(BACKENDS_BLOB))
        o0, a0 = origin.metrics(), agent.metrics()
        mi_path = "/namespace/{ns}/blobs/{d}/metainfo"

        async def cold_pull() -> dict:
            url = f"http://{agent.addr}/namespace/{quote(BACKENDS_NS, safe='')}/blobs/{d_b.hex}"
            h = hashlib.sha256()
            size = 0
            async with http_lite.ClientSession(timeout=timeout) as s:
                t0 = time.perf_counter()
                async with s.get(url) as r:
                    head = time.perf_counter()
                    async for chunk in r.content.iter_chunked(1 << 20):
                        h.update(chunk)
                        size += len(chunk)
                end = time.perf_counter()
            if r.status != 200:
                raise AssertionError(f"backends (b): GET on the agent answered {r.status}")
            return {"t0": t0, "head": head, "end": end, "digest": h.hexdigest(), "size": size}

        r = asyncio.run(cold_pull())
        if r["digest"] != d_b.hex or r["size"] != BACKENDS_BLOB:
            raise AssertionError("backends (b): the blob through the agent is not byte-identical")
        o1 = dedup_done(o0, 1)
        a1 = agent.metrics()
        got_b = counters(o0, o1, a0, a1)
        card_only("b", got_b, pieces_b)
        gets = fakes.gets.get(key_b, [])
        if len(gets) != 1 or got_b["origin_refresh_pulls"] != 1:
            raise AssertionError(f"backends (b): {len(gets)} GETs of the object, "
                                 f"{got_b['origin_refresh_pulls']} refreshes (one each wanted)")
        refresh_n = delta(o0, o1, "http_request_duration_seconds_count", component="origin",
                          endpoint=mi_path, method="GET")
        refresh_s = delta(o0, o1, "http_request_duration_seconds_sum", component="origin",
                          endpoint=mi_path, method="GET")
        (g0, g1), = gets
        with urllib.request.urlopen(
                f"http://{tracker.addr}/namespace/{quote(BACKENDS_NS, safe='')}/blobs/"
                f"{d_b.hex}/metainfo", timeout=60) as resp:
            mi_raw = resp.read()
        want_mi = MetaInfo(d_b, BACKENDS_BLOB, lengths.piece_length(BACKENDS_BLOB),
                           hashlib_pieces(blob_b, lengths.piece_length(BACKENDS_BLOB)))
        if mi_raw != want_mi.serialize():
            raise AssertionError("backends (b): the refreshed metainfo != MetaInfo over "
                                 "hashlib's piece hashes")
        stages = {s: delta(o0, o1, "ingest_stage_seconds_sum", stage=s)
                  for s in ("read", "pack", "transfer", "hash")}
        head_s, pull_s = r["head"] - r["t0"], r["end"] - r["t0"]
        emit({"phase": "backends", "leg": "b_cold_refresh", "blob_bytes": BACKENDS_BLOB,
              "pieces": pieces_b, "pull_s": pull_s, "gbps": BACKENDS_BLOB / pull_s / 1e9,
              "to_first_s3_byte_s": g0 - r["t0"], "s3_get_s": g1 - g0,
              "s3_get_gbps": BACKENDS_BLOB / (g1 - g0) / 1e9,
              "refresh_s": refresh_s, "refresh_requests": refresh_n,
              "commit_and_metainfo_s": refresh_s - (g1 - g0),
              "swarm_s": head_s - refresh_s, "serve_s": pull_s - head_s,
              "origin_ingest_stage_s": {k: v for k, v in stages.items() if v},
              **{k: got_b[k] for k in ("origin_launches", "agent_launches",
                                       "origin_cuda_pieces", "origin_dedup_chunks",
                                       "agent_cuda_batches", "agent_verified_pieces")},
              "what": "refresh_s: the origin's metainfo request (the tracker's, on the miss) "
                      "from /metrics: the S3 GET (s3_get_s, the fake's first to last byte), "
                      "the commit's digest check and the metainfo on the card; swarm_s: the "
                      "rest up to the agent's response head; serve_s: its body",
              "checks": ["blob byte-identical through the agent (SHA-256 = digest)",
                         "one GET of the object at the fake, one refresh at the origin",
                         "the metainfo through the tracker == MetaInfo over hashlib",
                         "no hashlib piece at the origin, no host verify batch at the agent"],
              "card": card_name_power})

        # (c) Pull-through by tag: the upstream holds the image; the agent's
        # registry resolves the tag through the build-index's registry_tag and
        # pulls the blobs, which the origin fetches through registry_blob.
        blobs_c, manifest = backends_image()
        m_digest = Digest.from_bytes(manifest)
        for b in (*blobs_c, manifest):
            fakes.upstream[f"{BACKENDS_REPO}/{Digest.from_bytes(b)}"] = b
        fakes.tags[f"{BACKENDS_REPO}:{BACKENDS_TAG}"] = manifest
        pieces_c = sum(-(-len(b) // lengths.piece_length(len(b))) for b in (*blobs_c, manifest))

        async def pull_by_tag() -> dict:
            base = f"http://{registry}/v2/{BACKENDS_REPO}"
            got = {"blobs": []}
            async with http_lite.ClientSession(timeout=timeout) as s:
                t0 = time.perf_counter()
                async with s.request("GET", f"{base}/manifests/{BACKENDS_TAG}",
                                     headers=DOCKER_ACCEPT) as r:
                    head_s = time.perf_counter() - t0
                    body = await r.read()
                if r.status != 200 or body != manifest:
                    raise AssertionError(f"backends (c): manifest by tag {r.status}, "
                                         f"identical {body == manifest}")
                got["manifest"] = {"swarm_s": head_s, "serve_s": time.perf_counter() - t0 - head_s}
                for want in blobs_c:
                    d = Digest.from_bytes(want)
                    t0 = time.perf_counter()
                    async with s.request("GET", f"{base}/blobs/{d}") as r:
                        head_s = time.perf_counter() - t0
                        body = await r.read()
                    if r.status != 200 or body != want:
                        raise AssertionError(f"backends (c): blob {str(d)[:19]} {r.status}, "
                                             f"identical {body == want}")
                    got["blobs"].append({"blob_bytes": len(want), "swarm_s": head_s,
                                         "serve_s": time.perf_counter() - t0 - head_s})
            return got

        o0, a0 = origin.metrics(), agent.metrics()
        t0 = time.perf_counter()
        first = asyncio.run(pull_by_tag())
        pull_c_s = time.perf_counter() - t0
        o1 = dedup_done(o0, 3)
        a1 = agent.metrics()
        got_c = counters(o0, o1, a0, a1)
        card_only("c", got_c, pieces_c)
        upstream_c = {"token_fetches": fakes.token_fetches, "challenges": fakes.challenges,
                      "blob_gets": len(fakes.blob_gets), "manifest_gets": len(fakes.manifest_gets),
                      "presigned_gets": len(fakes.presigned_auth),
                      "presigned_with_authorization": sum(a is not None
                                                          for a in fakes.presigned_auth)}
        t0 = time.perf_counter()
        second = asyncio.run(pull_by_tag())
        second_s = time.perf_counter() - t0
        o2, a2 = origin.metrics(), agent.metrics()
        second_launches = {"origin": launch_rise(o1, o2), "agent": launch_rise(a1, a2)}
        # One token a process that holds an upstream client (the build-index's
        # registry_tag, the origin's registry_blob), each cached for the rest.
        want_c = {"token_fetches": 2, "blob_gets": 3, "manifest_gets": 1, "presigned_gets": 3,
                  "presigned_with_authorization": 0}
        if {k: upstream_c[k] for k in want_c} != want_c or got_c["origin_refresh_pulls"] != 3:
            raise AssertionError(f"backends (c): upstream {upstream_c}, want {want_c}; "
                                 f"refreshes {got_c['origin_refresh_pulls']}")
        if (any(second_launches["origin"].values()) or any(second_launches["agent"].values())
                or fakes.token_fetches != 2 or len(fakes.blob_gets) != 3):
            raise AssertionError(f"backends (c): the second pull worked again: "
                                 f"{second_launches}, upstream {fakes.token_fetches} tokens, "
                                 f"{len(fakes.blob_gets)} blob GETs")
        with urllib.request.urlopen(
                f"http://{bindex.addr}/tags/"
                f"{quote(f'{BACKENDS_REPO}:{BACKENDS_TAG}', safe='')}", timeout=30) as resp:
            tag_digest = resp.read().decode()
        if tag_digest != str(m_digest):
            raise AssertionError(f"backends (c): the build-index holds {tag_digest}")
        emit({"phase": "backends", "leg": "c_pull_through", "pull_s": pull_c_s, "first": first,
              "second_pull_s": second_s, "second": second, "upstream": upstream_c,
              "second_pull_launches": second_launches,
              **{k: got_c[k] for k in ("origin_launches", "agent_launches", "origin_cuda_pieces",
                                       "agent_cuda_batches", "agent_verified_pieces",
                                       "origin_refresh_pulls")},
              "checks": ["manifest by tag and every blob byte-identical to the upstream's",
                         "one token fetch a process holding an upstream client (2), "
                         "none more on the second pull",
                         "no Authorization header on the presigned hop",
                         "the build-index's tag = the manifest's digest",
                         "no hashlib piece at the origin, no host verify batch at the agent",
                         "the second pull launched nothing"], "card": card_name_power})

        # (e) Drains: SIGTERM, each child 0 within its drain timeout.
        drains = {}
        for c in (agent, bindex, origin, tracker):
            cfg = load_config(str(REPO / "config" / c.name / "base.yaml"))
            limit = RPCConfig.from_dict(cfg.get("rpc")).drain_timeout_seconds
            t0 = time.perf_counter()
            rc = c.stop()
            drains[c.name] = time.perf_counter() - t0
            quiesced = c.name == "build-index" or "drain quiesced" in c.log()
            if rc != 0 or drains[c.name] > limit or not quiesced:
                raise AssertionError(f"backends (e): {c.name} exit {rc} after "
                                     f"{drains[c.name]:.1f} s:\n" + c.log()[-3000:])
        children.clear()

        # (d) The offline tools on the stopped nodes' stores, as an operator
        # runs them: each a CLI process, those that share no store at once.
        tools = {}
        agent_root, origin_root = os.path.join(root, "agent"), os.path.join(root, "origin")
        held = [d_b, *(Digest.from_bytes(b) for b in (*blobs_c, manifest))]

        def tool(args: list[str]) -> tuple[int, str, float]:
            t0 = time.perf_counter()
            rc, out = cli_tool(args)
            return rc, out, time.perf_counter() - t0

        t_tools = time.perf_counter()
        with ThreadPoolExecutor(5) as ex:
            runs = {name: ex.submit(tool, args) for name, args in {
                "scrub": ["scrub", "--store", agent_root],
                "scrub_no_root": ["scrub", "--store", os.path.join(root, "no-such-store")],
                "fsck": ["fsck", "--root", origin_root],
                "locate": ["locate", "--cluster", o_addr, "--digest", str(d_b)],
                "lint": ["lint", "kraken_tpu_torch/"],
            }.items()}
            testfs = HerdChild(root, "testfs", ["testfs", "--port", "0"])
            testfs.proc.send_signal(signal.SIGHUP)
            time.sleep(0.3)
            alive = testfs.proc.poll() is None
            rc = testfs.stop()
            tools["testfs"] = {"ready": testfs.ready, "ready_s": testfs.ready_s,
                               "alive_after_sighup": alive, "rc": rc}
            done = {name: f.result() for name, f in runs.items()}
        if not alive or rc != 0 or testfs.ready.get("component") != "testfs":
            raise AssertionError(f"backends (d): testfs {tools['testfs']}")
        rc, out, secs = done["scrub"]
        last = json.loads(out.strip().splitlines()[-1])
        tools["scrub"] = {"rc": rc, "checked": last.get("checked"), "s": secs}
        if rc != 0 or last != {"event": "scrub_done", "checked": len(held), "corrupt": 0}:
            raise AssertionError(f"backends (d): scrub of the agent's store: {rc} {out[-500:]}")
        rc, out, secs = done["scrub_no_root"]
        tools["scrub_no_root"] = {"rc": rc, "s": secs}
        if rc != 2:
            raise AssertionError(f"backends (d): scrub of a missing root exited {rc}")
        rc, out, secs = done["fsck"]
        tools["fsck"] = {"rc": rc, "report": json.loads(out.strip().splitlines()[-1]), "s": secs}
        if rc != 0:
            raise AssertionError(f"backends (d): fsck of the origin's store: {rc} {out[-500:]}")
        rc, out, secs = done["locate"]
        tools["locate"] = {"rc": rc, **json.loads(out), "s": secs}
        if rc != 0 or tools["locate"]["replicas"] != [o_addr]:
            raise AssertionError(f"backends (d): locate {rc} {out[-500:]}")
        rc, out, secs = done["lint"]
        lint = json.loads(out.strip().splitlines()[-1])
        tools["lint"] = {"rc": rc, "files": lint.get("files"), "findings": lint.get("findings"),
                         "s": secs}
        if rc != 0 or lint.get("findings") != 0:
            raise AssertionError(f"backends (d): lint kraken_tpu_torch/: {rc} {out[-2000:]}")
        victim = Digest.from_bytes(blobs_c[0])
        path = os.path.join(agent_root, "cache", victim.hex[:2], victim.hex[2:4], victim.hex)
        with open(path, "r+b") as f:
            byte = f.read(1)
            f.seek(0)
            f.write(bytes([byte[0] ^ 0x01]))
        rc, out, secs = tool(["scrub", "--store", agent_root])
        lines = [json.loads(line) for line in out.strip().splitlines()]
        tools["scrub_flipped"] = {"rc": rc, "corrupt": [x["digest"] for x in lines
                                                        if x.get("event") == "corrupt"],
                                  "s": secs}
        if rc != 1 or tools["scrub_flipped"]["corrupt"] != [victim.hex]:
            raise AssertionError(f"backends (d): scrub after a flipped byte: {rc} {out[-500:]}")
        tools_s = time.perf_counter() - t_tools
        emit({"phase": "backends", "leg": "d_tools", "tools": tools, "wall_s": tools_s,
              "checks": [f"scrub of the agent's store: 0, checked {len(held)} (its blobs)",
                         "scrub after one flipped byte: 1, naming that digest",
                         "scrub of a missing root: 2", "fsck of the origin's store: 0",
                         "locate names the origin", "lint kraken_tpu_torch/: 0, no finding",
                         "testfs: READY, alive after SIGHUP, 0 on SIGTERM"],
              "card": card_name_power})
        emit({"phase": "backends", "leg": "e_drains", "drain_to_exit_s": drains,
              "card": card_name_power})
        return {"launches": {"origin": {k: got_b["origin_launches"][k] + got_c["origin_launches"][k]
                                        for k in BACKENDS_KERNELS},
                             "agent": {k: got_b["agent_launches"][k] + got_c["agent_launches"][k]
                                       for k in BACKENDS_KERNELS}},
                "cold_pull_s": pull_s, "refresh_s": refresh_s, "writeback_s": landed - acked}
    finally:
        for c in children:
            c.stop(kill=True)
        fakes.close()


# -- phase 20, the parallel hash plane ----------------------------------------
# The sharded hasher on the card's default mesh, the origin's pipeline on it
# through the staged-window protocol, four processes federating their digests
# over gloo, and a ``--hasher cuda-sharded`` origin of the CLI. The machine
# has one card, so the mesh has one device: the phase shows the path runs and
# agrees, not a speed-up across cards.

PARALLEL_NS = "library/parallel"
PARALLEL_BLOB = GiB
PARALLEL_RANKS = 4
PARALLEL_TIMEOUT_S = 180.0


def parallel_phase(root: str, card_name_power: str) -> dict:
    """Phase 20: (a) ``ShardedPieceHasher()`` beside ``TorchPieceHasher``
    on 1 GiB + 12,345 B, (b) ``IngestPipeline(get_hasher("cuda-sharded"),
    IngestConfig())`` on 1 GiB, (c) four ranks of ``python -m
    kraken_tpu_torch.parallel.multihost`` on the card, (d) a ``--hasher
    cuda-sharded`` origin of the CLI taking 1 GiB. Returns the launches
    and walls that the kernels line carries."""
    from kraken_tpu_torch import (
        Digest, IngestConfig, IngestPipeline, MetaInfo, TorchPieceHasher, get_hasher,
    )
    from kraken_tpu_torch.configutil import load_config
    from kraken_tpu_torch.ops import sha256_cuda
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.parallel import ShardedPieceHasher
    from kraken_tpu_torch.parallel.multihost import SELFTEST_PIECE, _batch_of
    from kraken_tpu_torch.utils.deadline import RPCConfig
    from kraken_tpu_torch.utils.httputil import HTTPClient

    rng = np.random.default_rng(SEED + 200)
    blob = rng.bytes(PARALLEL_BLOB + TAIL)
    want = hashlib_pieces(blob, PIECE)
    n_full = PARALLEL_BLOB // PIECE

    # (a) The sharded hasher and the single-device one on the same bytes,
    # in turns (sharded, single, single, sharded); the launches are the
    # first sharded call's.
    sharded, single = ShardedPieceHasher(), TorchPieceHasher()
    mesh = sharded.mesh
    walls: dict[str, list] = {"cuda-sharded": [], "cuda": []}
    launches_a = None
    for h in (sharded, single, single, sharded):
        sha256_cuda.reset_launches()
        t0 = time.perf_counter()
        got = h.hash_pieces(blob, PIECE)
        walls[h.name].append(time.perf_counter() - t0)
        if got.tobytes() != want:
            raise AssertionError(f"parallel (a): {h.name} != hashlib")
        if launches_a is None:
            launches_a = dict(sha256_cuda.LAUNCHES)
    if launches_a != {"sha256_uniform": mesh.size, "sha256_ragged": 1,
                      "pack_tiles_device": 0, "sha256_packed_tiles": 0}:
        raise AssertionError(f"parallel (a): launches {launches_a} on a mesh of {mesh.size}")
    emit({"phase": "parallel", "leg": "a_hasher", "blob_bytes": len(blob),
          "piece_length": PIECE, "mesh_size": mesh.size,
          "mesh_devices": [str(d) for d in mesh.devices], "launches": launches_a,
          "wall_s": walls, "order": ["cuda-sharded", "cuda", "cuda", "cuda-sharded"],
          "checks": ["ShardedPieceHasher == hashlib == TorchPieceHasher, every piece",
                     "one sha256_uniform a mesh device, one sha256_ragged for the tail"],
          "card": card_name_power})

    # (b) The origin's pipeline on the sharded hasher: 16 windows of 64 MiB,
    # each staged on the mesh, then hashed.
    pipe = IngestPipeline(get_hasher("cuda-sharded"), IngestConfig())
    view = memoryview(blob)[:PARALLEL_BLOB]
    sha256_cuda.reset_launches()
    t0 = time.perf_counter()
    ses = pipe.session(PIECE)
    off = 0
    while off < len(view):
        buf = ses.begin_window()
        n = min(len(buf), len(view) - off)
        buf[:n] = view[off : off + n]
        off += n
        ses.submit(n)
    got = ses.finish()
    ingest_s = time.perf_counter() - t0
    launches_b = dict(sha256_cuda.LAUNCHES)
    windows = -(-PARALLEL_BLOB // IngestConfig().window_bytes)
    if got.tobytes() != want[: n_full * 32] or ses._fell_back:
        raise AssertionError("parallel (b): the pipeline's digests != hashlib")
    if (launches_b["sha256_uniform"] != windows * mesh.size or launches_b["sha256_ragged"]
            or not ses.stage_seconds["transfer"] > 0 or not ses.stage_seconds["hash"] > 0):
        raise AssertionError(f"parallel (b): not the staged path: {launches_b} "
                             f"{ses.stage_seconds}")
    emit({"phase": "parallel", "leg": "b_ingest", "blob_bytes": PARALLEL_BLOB,
          "window_bytes": ses.window_bytes, "windows": ses.windows, "launches": launches_b,
          "stage_seconds": ses.stage_seconds, "wall_s": ingest_s,
          "gbps": PARALLEL_BLOB / ingest_s / 1e9, "overlap_ratio": ses.overlap_ratio(),
          "checks": ["digests == hashlib", "every window staged (transfer > 0) then hashed"],
          "card": card_name_power})
    del blob, view, got
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Four ranks on the card, each hashing its own batch of 4 MiB pieces
    # and gathering the digests over gloo.
    plen = SELFTEST_PIECE["cuda"]
    want_c = hashlib.sha256(b"".join(
        hashlib.sha256(row.tobytes()).digest()
        for p in range(PARALLEL_RANKS) for row in _batch_of(p, plen))).hexdigest()
    (port,) = free_ports(1)
    t0 = time.perf_counter()
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "kraken_tpu_torch.parallel.multihost", str(p),
         str(PARALLEL_RANKS), str(port), "--platform", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO))) for p in range(PARALLEL_RANKS)]
    stats = []
    try:
        for p, proc in enumerate(ranks):
            out, err = proc.communicate(timeout=PARALLEL_TIMEOUT_S)
            line = next((ln for ln in out.splitlines() if ln.startswith("MULTIHOST-OK")), "")
            digests = sum(3 + q for q in range(PARALLEL_RANKS))
            if proc.returncode != 0 or not line.startswith(
                    f"MULTIHOST-OK proc={p} digests={digests} "):
                raise AssertionError(f"parallel (c): rank {p} exit {proc.returncode}:\n"
                                     f"{out[-2000:]}\n{err[-3000:]}")
            stats.append(json.loads(line.split(" ", 3)[3]))
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t0
    for p, s in enumerate(stats):
        if s["global_sha256"] != want_c or s["platform"] != "cuda":
            raise AssertionError(f"parallel (c): rank {p}'s global matrix != hashlib: {s}")
        if s["launches"]["sha256_uniform"] < 1:
            raise AssertionError(f"parallel (c): rank {p} launched no kernel: {s}")
    emit({"phase": "parallel", "leg": "c_multihost", "ranks": PARALLEL_RANKS,
          "piece_length": plen, "rows_per_rank": [3 + p for p in range(PARALLEL_RANKS)],
          "launches": [s["launches"] for s in stats],
          "hash_and_gather_s": [s["hash_and_gather_s"] for s in stats],
          "gather_s": [s["gather_s"] for s in stats], "spawn_to_exit_s": ranks_s,
          "checks": ["every rank's global [N, 32] matrix == hashlib over all four batches",
                     "every rank exit 0, each launching on the card"],
          "card": card_name_power})

    # (d) A --hasher cuda-sharded origin of the CLI takes 1 GiB.
    origin = HerdChild(root, "origin", ["origin", "--config", herd_config(root, "origin"),
                                        "--hasher", "cuda-sharded"])
    try:
        blob = np.random.default_rng(SEED + 201).bytes(PARALLEL_BLOB)
        d = Digest.from_bytes(blob)
        pieces = hashlib_pieces(blob, PIECE)
        o0 = origin.metrics()

        async def upload() -> tuple[float, bytes]:
            client = BlobClient(origin.addr, HTTPClient(retries=0))
            http = HTTPClient(retries=0, timeout_seconds=PARALLEL_TIMEOUT_S)
            try:
                t0 = time.perf_counter()
                await asyncio.wait_for(
                    client.upload(PARALLEL_NS, d, blob, chunk_size=ORIGIN_CHUNK),
                    PARALLEL_TIMEOUT_S)
                secs = time.perf_counter() - t0
                raw = await http.get(f"http://{origin.addr}/namespace/"
                                     f"{quote(PARALLEL_NS, safe='')}/blobs/{d.hex}/metainfo")
            finally:
                await client.close()
                await http.close()
            return secs, raw

        upload_s, raw = asyncio.run(upload())
        if raw != MetaInfo(d, len(blob), PIECE, pieces).serialize():
            raise AssertionError("parallel (d): GET /metainfo != MetaInfo over hashlib")
        deadline = time.perf_counter() + PARALLEL_TIMEOUT_S
        o1 = origin.metrics()
        while metric(o1, "origin_dedup_indexed_blobs") < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("parallel (d): the origin's dedup pass did not finish")
            time.sleep(0.5)
            o1 = origin.metrics()
        got_d = {
            "launches": {k: delta(o0, o1, "kernel_launches_total", kernel=k)
                         for k in ("sha256_uniform", "sha256_ragged", "gear_candidates")},
            "sharded_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cuda-sharded"),
            "cpu_pieces": delta(o0, o1, "hasher_pieces_total", hasher="cpu"),
            "ingest_windows": delta(o0, o1, "ingest_windows_total", hasher="cuda-sharded"),
        }
        windows = -(-PARALLEL_BLOB // HERD_WINDOW)
        if (got_d["sharded_pieces"] != n_full or got_d["cpu_pieces"]
                or got_d["ingest_windows"] != windows
                or got_d["launches"]["sha256_uniform"] < windows * mesh.size):
            raise AssertionError(f"parallel (d): the origin's windows were not on the card: {got_d}")
        limit = RPCConfig.from_dict(
            load_config(str(REPO / "config" / "origin" / "base.yaml")).get("rpc")
        ).drain_timeout_seconds
        t0 = time.perf_counter()
        rc = origin.stop()
        drain_s = time.perf_counter() - t0
        if rc != 0 or drain_s > limit:
            raise AssertionError(f"parallel (d): SIGTERM gave exit {rc} after {drain_s:.1f} s:\n"
                                 + origin.log()[-3000:])
    finally:
        origin.stop(kill=True)
    emit({"phase": "parallel", "leg": "d_cli_origin", "ready_s": origin.ready_s,
          "blob_bytes": PARALLEL_BLOB, "upload_to_201_s": upload_s,
          "gbps": PARALLEL_BLOB / upload_s / 1e9, **got_d, "drain_to_exit_s": drain_s,
          "checks": ["READY with --hasher cuda-sharded",
                     "GET /metainfo == MetaInfo over hashlib",
                     f"{n_full} pieces hashed in {windows} staged windows on the card, "
                     "none by hashlib", "SIGTERM: exit 0"],
          "card": card_name_power})
    return {"a": launches_a, "b": launches_b,
            "c": [s["launches"] for s in stats], "d": got_d["launches"],
            "walls": walls, "ingest_s": ingest_s, "stage_seconds": ses.stage_seconds,
            "gather_s": [s["gather_s"] for s in stats]}


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
    from kraken_tpu_torch.ops import cdc as cdc_mod
    from kraken_tpu_torch.ops import cdc_cuda, cuda_lib, sha256_cuda, transpose_cuda
    from kraken_tpu_torch.ops.cdc_cuda import LEAD, candidate_indices, gear_candidates, padded
    from kraken_tpu_torch.ops.cdc_ref import gear_candidates_ref, gear_candidates_window_ref
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
    sass = card.sass
    sha_sass = {k: card.sass_per_block(k) for k in (ROWS_KERNEL, PACKED_KERNEL)}
    gear_sass = gear_sass_per_byte(sass)
    emit({"phase": "build", "seconds": build_secs,
          "library": str(lib.relative_to(REPO)), "ptxas": ptxas,
          "gear_sass_instructions": sass_instructions(sass, GEAR_KERNEL),
          "gear_sass_per_byte": gear_sass,
          "sha_sass_per_block": sha_sass,
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

    # The prefetch's edges: rows of 0-3 full blocks with tails of 0, 55, 56
    # and 63 bytes, as ragged rows (16-byte aligned, then skewed) and as
    # 33 uniform rows of each length (a full warp and one more lane).
    edge = [64 * b + t for b in range(4) for t in (0, 55, 56, 63)]
    pieces = [rng.bytes(n) for n in edge]
    for align, skew in ((16, 0), (4, 4), (1, 1)):
        args = ragged_inputs(pieces, align, skew)
        errs.append(hold(f"edge rows align {align}", sha256_ragged(*args),
                         sha256_rows_ref(*args), pieces))
        checks.append(f"ragged rows of 0-3 blocks + 0/55/56/63 B, align {align} skew {skew}")
    for n in edge:
        rows = torch.from_numpy(rng.integers(0, 256, (33, n), dtype=np.uint8)).to(dev)
        errs.append(hold(f"uniform 33 x {n}", sha256_uniform(rows), sha256_uniform_ref(rows),
                         [bytes(r) for r in rows.cpu().numpy()]))
    checks.append("uniform 33 rows of each edge length")
    # Rows that end at the last byte of an exact-size tensor in a segment of
    # its own (compute-sanitizer does not run on the card machine; a read
    # past the end must fault here or not happen).
    torch.cuda.empty_cache()
    exact = torch.from_numpy(rng.integers(0, 256, 16 * MiB, dtype=np.uint8)).to(dev)
    host_exact = exact.cpu().numpy().tobytes()
    ends = [64, 124, 55, 4096, 16 * KiB + 63, 4 * MiB]
    offs = torch.tensor([16 * MiB - n for n in ends], device=dev)
    lens = torch.tensor(ends, device=dev)
    tails = [host_exact[16 * MiB - n :] for n in ends]
    errs.append(hold("rows ending at the tensor's end", sha256_ragged(exact, offs[:5], lens[:5]),
                     sha256_rows_ref(exact, offs[:5], lens[:5]), tails[:5]))
    hold("4 MiB row ending at the tensor's end", sha256_ragged(exact, offs[5:], lens[5:]),
         None, tails[5:])
    hold("4 x 4 MiB uniform rows filling the tensor", sha256_uniform(exact.view(4, 4 * MiB)),
         None, [host_exact[i * 4 * MiB : (i + 1) * 4 * MiB] for i in range(4)])
    checks.append("rows ending at the last byte of an exact 16 MiB tensor "
                  "(64, 124, 55, 4096, 16 KiB + 63 B vs plain; 4 MiB and 4 x 4 MiB uniform vs hashlib)")
    del exact

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
    def sha_leg(kernel, ms, blocks, longest, nbytes):
        """A SHA-256 launch's time beside its bounds, and its cycles a block
        of the longest row at the SM clock read right after it."""
        clock = card.sm_clock_mhz()
        b = card.sha_bound(kernel, blocks, longest, nbytes)
        return {"ms": ms, **b, "share_of_bound": b["bound_ms"] / ms,
                "share_of_chain_bound": b["chain_bound_ms"] / ms,
                "cycles_per_block": ms * 1e3 * clock / longest, "sm_clock_mhz": clock}

    x = torch.randint(0, 256, (1024, PIECE), dtype=torch.uint8, device=dev)
    words = sha256_uniform(x)  # warm-up
    times = [cuda_ms(lambda: sha256_uniform(x)) for _ in range(3)]
    batch_ms = statistics.median(times)
    host = memoryview(x.cpu().numpy().reshape(-1))
    want = oracle.hash_pieces(host, PIECE)
    if not np.array_equal(words_to_bytes(words), want):
        raise AssertionError("batch: kernel != hashlib")
    batch_leg = sha_leg(ROWS_KERNEL, batch_ms, *rows_work([PIECE] * 1024))
    hasher = TorchPieceHasher(sub_batch_bytes=1024 * PIECE)
    t0 = time.perf_counter()
    via_hasher = hasher.hash_pieces(host, PIECE)
    hasher_secs = time.perf_counter() - t0
    if not np.array_equal(via_hasher, want):
        raise AssertionError("batch: hasher != hashlib")
    emit({"phase": "batch", "pieces": 1024, "piece_length": PIECE,
          "kernel_ms": times, "kernel_ms_median": batch_ms,
          "kernel_gbps": 1024 * PIECE / batch_ms / 1e6,
          **batch_leg,
          "hasher_seconds": hasher_secs,
          "hasher_gbps": 1024 * PIECE / hasher_secs / 1e9})

    # -- each wrapper at the main path's launch shape ------------------------
    # The origin's window and the agent's verify group are both 64 rows of
    # 4 MiB (256 MiB sub-batches of the cuda hasher).
    win = x[:64]
    sha256_uniform(win)
    uni_main_ms = statistics.median(cuda_ms(lambda: sha256_uniform(win)) for _ in range(3))
    uni_main = sha_leg(ROWS_KERNEL, uni_main_ms, *rows_work([PIECE] * 64))
    flat = x.view(-1)[: 64 * PIECE]
    offs = torch.arange(64, device=dev) * PIECE
    lens = torch.full((64,), PIECE, device=dev)
    rag_main_ms = statistics.median(
        cuda_ms(lambda: sha256_ragged(flat, offs, lens)) for _ in range(3)
    )
    rag_main = sha_leg(ROWS_KERNEL, rag_main_ms, *rows_work([PIECE] * 64))
    emit({"phase": "main_shape", "shape": "64 x 4 MiB",
          "sha256_uniform": uni_main, "sha256_ragged": rag_main})
    del win, flat

    # -- 6. packed: the two kernels of csrc/sha256_packed.cu ------------------
    def word_err(a, b):
        """max |a - b| over uint32 words (0 when equal)."""
        if torch.equal(a, b):
            return 0
        return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF)).abs().max())

    checks, pack_errs, packed_errs = [], [], []
    # nb = 1, 2 and 8 = NB (the last block hashed is the tensor's last) for
    # the prefetch's edges.
    for m, p in ((1024, 576), (2048, 64), (1024, 64), (1024, 128), (1024, 512)):
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
    packed_main = sha_leg(PACKED_KERNEL, packed_ms, *packed_work(1024, nb))
    emit({"phase": "packed", "checks": checks, "max_abs_err": 0,
          "pack_1024x4MiB": {"kernel_ms": pack_ms, "plain_ms": pack_plain_ms,
                             "library_ms": pack_library_ms, "bound_ms": pack_bound_ms,
                             "gbps": 2 * 1024 * PIECE / pack_ms / 1e6},
          "packed_1024x4MiB": {**packed_main, "gbps": 1024 * PIECE / packed_ms / 1e6},
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

    def cand_err(got, want):
        """Strict and loose positions in one list and not the other (0 when
        the lists are equal; at least 1 when they differ)."""
        if all(np.array_equal(g, w) for g, w in zip(got, want)):
            return 0
        return max(1, sum(int(np.setxor1d(g, w).size) for g, w in zip(got, want)))

    # Four windows, kernel against plain, position for position: the main
    # path's two (the blob's first, ragged; a whole one after it), a 1 MiB
    # window at mask 0 (every position a candidate, the code buffer full)
    # and one at dense parameters (loose candidates ~1 in 64).
    dense = CDCParams(64, 256, 1024)
    for n, hist, masks, label in (
        (win - TAIL, 0, (ms_, ml_), "default"), (win, 31, (ms_, ml_), "default"),
        (MiB, 31, (0, 0), "mask 0"),
        (MiB, 17, (dense.mask_strict, dense.mask_loose), "CDCParams(64, 256, 1024)"),
    ):
        buf = torch.from_numpy(rng.integers(0, 256, LEAD + padded(n), dtype=np.uint8)).to(dev)
        got = gear_candidates(buf, n, hist, *masks)
        want = gear_candidates_window_ref(buf, n, hist, *masks, LEAD)
        gear_errs.append(cand_err(got, want))
        if masks == (0, 0) and not len(want[0]) == len(want[1]) == n:
            raise AssertionError("cdc: mask 0 did not make every position a candidate")
        checks.append(f"one window of {n} B, {hist} B of history, {label} masks: "
                      f"{len(want[0])} strict, {len(want[1])} loose, vs plain")
        if n == win:
            wbuf = buf
    del buf
    # The main path's launch: a whole 64 MiB window after the first. A
    # launch takes less time on the card than the host takes to issue it,
    # so it is timed queued (a median of 3 runs of 10 launches), and beside
    # it as ``cuda_ms`` times every other kernel, on an idle card.
    out = torch.empty(win + 1, dtype=torch.int32, device=dev)
    cdc_cuda.launch(wbuf, win, 31, ms_, ml_, out)  # warm
    gear_ms = statistics.median(
        queued_ms(lambda: cdc_cuda.launch(wbuf, win, 31, ms_, ml_, out)) for _ in range(3))
    gear_clock_mhz = card.sm_clock_mhz()
    gear_idle_ms = statistics.median(
        cuda_ms(lambda: cdc_cuda.launch(wbuf, win, 31, ms_, ml_, out)) for _ in range(3))
    gear_codes = int(out[0])
    del out
    gear_plain_ms = cuda_ms(lambda: gear_candidates_window_ref(wbuf, win, 31, ms_, ml_, LEAD))

    def i32(v):
        return v - (1 << 32) if v >= 1 << 31 else v

    def library_gear():
        """One PyTorch expression for the window's candidates: the gear map
        and the log-doubling in int32 with wraparound, both mask tests,
        then ``torch.nonzero`` of each."""
        x = wbuf[LEAD - 31 : LEAD + win].to(torch.int32)
        x = (x + 1) * i32(0x9E3779B1)
        x = x ^ ((x >> 15) & 0x1FFFF)
        x = x * i32(0x85EBCA77)
        h = x ^ ((x >> 13) & 0x7FFFF)
        step = 1
        while step < 32:
            h = h + (torch.cat([h.new_zeros(step), h[:-step]]) << step)
            step *= 2
        h = h[31:]
        return (torch.nonzero((h & i32(ms_)) == 0).squeeze(1),
                torch.nonzero((h & i32(ml_)) == 0).squeeze(1))

    if cand_err([t.cpu().numpy() for t in library_gear()],
                gear_candidates(wbuf, win, 31, ms_, ml_)):
        raise AssertionError("the library expression is not the gear pass")
    gear_library_ms = statistics.median(cuda_ms(library_gear) for _ in range(3))
    # Bytes: the window and its 31 bytes of history read, the count and the
    # codes this window's data made written.
    gear_leg = gear_bounds(win, win + 31 + 4 * (1 + gear_codes), card.sms, card.sm_clock_hz)
    gear_leg["share_of_bound"] = gear_leg["bound_ms"] / gear_ms
    del wbuf

    # The copy into pinned staging, which sets the window path's pace once
    # the rest overlaps: 64 MiB from host memory, one thread and
    # COPY_THREADS (a median of 3 each).
    src = rng.integers(0, 256, win, dtype=np.uint8)
    dst = torch.empty(win, dtype=torch.uint8, pin_memory=True).numpy()
    copy_gbps, keep = {}, cdc_cuda.COPY_THREADS
    for threads in sorted({1, keep}):
        cdc_cuda.COPY_THREADS = threads
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            cdc_cuda._copy(dst, src)
            secs.append(time.perf_counter() - t0)
        copy_gbps[threads] = win / statistics.median(secs) / 1e9
    cdc_cuda.COPY_THREADS = keep
    del src, dst

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

    select = {"seconds": 0.0}
    host_select = cdc_mod._host_select_cuts

    def timed_select(*args):
        t0 = time.perf_counter()
        cuts = host_select(*args)
        select["seconds"] += time.perf_counter() - t0
        return cuts

    cdc_mod._host_select_cuts = timed_select
    cdc_cuda.reset_stages()
    t0 = time.perf_counter()
    cuts_a = chunk(blob_a, params)
    chunk_secs = time.perf_counter() - t0
    chunk_stages = {**cdc_cuda.STAGES, "select_cuts": select["seconds"]}
    cdc_mod._host_select_cuts = host_select
    if cuts_a != c_cuts("A", blob_a):
        raise AssertionError("cdc: 1 GiB kernel-route cuts != the C chunker's")
    checks.append(f"1 GiB: {len(cuts_a)} cuts through the kernel route == C chunker")
    gear_err = max(gear_errs)
    if gear_err:
        raise AssertionError(f"cdc: gear kernel != plain version (max abs err {gear_err})")
    emit({"phase": "cdc", "checks": checks, "max_abs_err": gear_err,
          "window_64MiB": {"kernel_ms": gear_ms, "plain_ms": gear_plain_ms,
                           "library_ms": gear_library_ms, **gear_leg, "codes": gear_codes,
                           "ms_launched_on_an_idle_card": gear_idle_ms,
                           "sass_per_byte": gear_sass,
                           "gbps": win / gear_ms / 1e6, "sm_clock_mhz": gear_clock_mhz},
          "host_copy_64MiB_gbps": copy_gbps,
          "chunk_1GiB": {"seconds": chunk_secs, "gbps": GiB / chunk_secs / 1e9,
                         "stage_seconds": chunk_stages, "windows": -(-GiB // win),
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
        t_ms, t_by = card.bound_of(m * p // 2, m * p + m * 32)  # bswap + xor a word
        bounds = {
            "transpose_only": {"bound_ms": t_ms, "bound_by": t_by},
            "natural": card.sha_bound(ROWS_KERNEL, *rows_work([p] * m)),
            "rounds_only_packed": card.sha_bound(PACKED_KERNEL, *packed_work(m, nb)),
        }
        return {name: {"ms": r[f"{name}_ms"], "gbps": r[f"{name}_gbps"], **b,
                       "share_of_bound": b["bound_ms"] / r[f"{name}_ms"]}
                for name, b in bounds.items()}

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

    # -- 11. swarm: port schedulers over loopback, verify on the card -------
    gc.collect()
    torch.cuda.empty_cache()
    work.mkdir(exist_ok=True)
    swarm_start = time.perf_counter()
    try:
        swarm = asyncio.run(swarm_legs(tempfile.mkdtemp(dir=work), card.name_power))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    swarm_secs = time.perf_counter() - swarm_start

    # -- 12. tracker: the flash crowd through a tracker fleet over HTTP -----
    gc.collect()
    work.mkdir(exist_ok=True)
    tracker_start = time.perf_counter()
    try:
        fleet = asyncio.run(tracker_fleet(tempfile.mkdtemp(dir=work), card.name_power))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tracker_secs = time.perf_counter() - tracker_start

    # -- 13. origin_http: uploads to the port's origin over HTTP ----------
    gc.collect()
    work.mkdir(exist_ok=True)
    origin_start = time.perf_counter()
    try:
        origin_legs = asyncio.run(origin_http(tempfile.mkdtemp(dir=work), card.name_power))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    origin_secs = time.perf_counter() - origin_start

    # -- 14. herd: origin, tracker and agent as processes of the port's CLI -
    gc.collect()
    torch.cuda.empty_cache()
    work.mkdir(exist_ok=True)
    herd_start = time.perf_counter()
    own = OriginLaunches()
    own.reset()
    try:
        herd = herd_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    herd_secs = time.perf_counter() - herd_start
    if any(own.read().values()):
        raise AssertionError(f"herd: this process launched kernels: {own.read()}")
    hc = herd["counters"]

    # -- 15. front_door: docker push to the proxy, pull by tag from the agent -
    gc.collect()
    work.mkdir(exist_ok=True)
    front_start = time.perf_counter()
    own.reset()
    try:
        front = front_door_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    front_secs = time.perf_counter() - front_start
    if any(own.read().values()):
        raise AssertionError(f"front door: this process launched kernels: {own.read()}")
    fc = front["counters"]

    # -- 16. delta: build over build through the chunk tier and delta pulls -
    gc.collect()
    work.mkdir(exist_ok=True)
    delta_start = time.perf_counter()
    own.reset()
    try:
        dlt = delta_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    delta_secs = time.perf_counter() - delta_start
    if any(own.read().values()):
        raise AssertionError(f"delta: this process launched kernels: {own.read()}")
    dc = dlt["counters"]

    # -- 17. operator: the canary, the mux, torch-profile, the tools -------
    gc.collect()
    work.mkdir(exist_ok=True)
    operator_start = time.perf_counter()
    own.reset()
    try:
        op = operator_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    operator_secs = time.perf_counter() - operator_start
    if any(own.read().values()):
        raise AssertionError(f"operator: this process launched kernels: {own.read()}")

    # -- 18. shards: pulls through forked workers beside the CUDA context -
    gc.collect()
    work.mkdir(exist_ok=True)
    shards_start = time.perf_counter()
    own.reset()
    try:
        sh = shards_phase(tempfile.mkdtemp(dir=work), card.name_power, herd["pull_s"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    shards_secs = time.perf_counter() - shards_start
    if any(own.read().values()):
        raise AssertionError(f"shards: this process launched kernels: {own.read()}")

    # -- 19. backends: S3 writeback and cold refresh, pull-through, tools --
    gc.collect()
    work.mkdir(exist_ok=True)
    backends_start = time.perf_counter()
    own.reset()
    try:
        bk = backends_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    backends_secs = time.perf_counter() - backends_start
    if any(own.read().values()):
        raise AssertionError(f"backends: this process launched kernels: {own.read()}")

    # -- 20. parallel: the sharded hasher, staged windows, ranks over gloo --
    gc.collect()
    torch.cuda.empty_cache()
    work.mkdir(exist_ok=True)
    parallel_start = time.perf_counter()
    try:
        par = parallel_phase(tempfile.mkdtemp(dir=work), card.name_power)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parallel_secs = time.perf_counter() - parallel_start

    def parallel_launches(name: str) -> dict:
        """Phase 20's launches of one wrapper: (a) and (b) in this process,
        (c) by rank, (d) at the CLI origin."""
        return {"a_hasher": par["a"][name], "b_ingest": par["b"][name],
                "c_ranks": [r[name] for r in par["c"]], "d_cli_origin": par["d"][name]}

    def backends_launches(name: str) -> dict:
        """Phase 19's launches of one wrapper, by process ((b) and (c))."""
        return {proc: bk["launches"][proc].get(name, 0.0) for proc in ("origin", "agent")}

    def shards_launches(name: str) -> dict:
        """Phase 18's launches of one wrapper, by process."""
        return {proc: sh["launches"][proc][name] for proc in ("origin", "agent_a", "agent_b")}

    def operator_launches(name: str) -> dict:
        """Phase 17's launches of one wrapper, by process."""
        return {proc: op["launches"][proc].get(name, 0) for proc in ("origin", "agent")}

    def delta_launches(name: str) -> dict:
        """Phase 16's launches of one wrapper, by process."""
        return {"origin": dc["origin_launches"][name], "agent_a": dc["a_launches"][name],
                "agent_b": dc["b_launches"][name]}

    def origin_launches(name: str) -> dict:
        """Phase 13's launches of one wrapper, by leg."""
        return {leg: r["launches"].get(name, 0) for leg, r in origin_legs.items()
                if "launches" in r}

    print(card.name_power, flush=True)
    def sha_entry(leg, kernel):
        """A SHA-256 entry's bounds, and its per-block loop as built."""
        return {"bound_ms": leg["bound_ms"], "bound_by": leg["bound_by"],
                "chain_bound_ms": leg["chain_bound_ms"],
                "throughput_bound_ms": leg["throughput_bound_ms"],
                "sass_per_block": sha_sass[kernel], "cycles_per_block": leg["cycles_per_block"]}

    common = {"route": "cuda", "source": "kraken_tpu_torch/csrc/sha256.cu",
              "max_abs_err": max_abs_err, "library_ms": None, "shape": "64 x 4 MiB",
              "plain_shape": "64 x 16 KiB (+1 x 12,345 B ragged)"}
    emit({"kernels": [
        {"name": "sha256_uniform", **common,
         "replaces": "kraken_tpu/ops/sha256_pallas.py:199",
         "launches": main_launches["sha256_uniform"], "ms": uni_main_ms,
         "plain_ms": uni_plain_ms, "ms_at_plain_shape": uni_ms,
         "swarm_metainfo_launches": {leg: r["metainfo_launches"]["sha256_uniform"]
                                     for leg, r in swarm.items()},
         "swarm_launches": {leg: r["launches"]["sha256_uniform"] for leg, r in swarm.items()},
         "tracker_metainfo_launches": fleet["metainfo_launches"]["sha256_uniform"],
         "tracker_launches": fleet["launches"]["sha256_uniform"],
         "origin_http_launches": origin_launches("sha256_uniform"), "delta_launches": delta_launches("sha256_uniform"),
         "operator_launches": operator_launches("sha256_uniform"),
         "shards_launches": shards_launches("sha256_uniform"),
         "backends_launches": backends_launches("sha256_uniform"),
         "parallel_launches": parallel_launches("sha256_uniform"),
         "herd_launches": {"origin": hc["origin_launches"]["sha256_uniform"],
                           "agent": hc["agent_launches"]["sha256_uniform"]},
         "herd_origin_ingest_windows": hc["origin_ingest_windows"],
         "front_door_launches": {"origin": fc["origin_launches"]["sha256_uniform"],
                                 "agent": fc["agent_launches"]["sha256_uniform"]},
         "front_door_origin_ingest_windows": fc["origin_ingest_windows"],
         **sha_entry(uni_main, ROWS_KERNEL)},
        {"name": "sha256_ragged", **common,
         "replaces": "kraken_tpu/ops/sha256.py:140",
         "launches": main_launches["sha256_ragged"], "ms": rag_main_ms,
         "plain_ms": rag_plain_ms, "ms_at_plain_shape": rag_ms,
         "swarm_launches": {leg: r["launches"]["sha256_ragged"] for leg, r in swarm.items()},
         "tracker_metainfo_launches": fleet["metainfo_launches"]["sha256_ragged"],
         "tracker_launches": fleet["launches"]["sha256_ragged"],
         "origin_http_launches": origin_launches("sha256_ragged"), "delta_launches": delta_launches("sha256_ragged"),
         "operator_launches": operator_launches("sha256_ragged"),
         "shards_launches": shards_launches("sha256_ragged"),
         "backends_launches": backends_launches("sha256_ragged"),
         "parallel_launches": parallel_launches("sha256_ragged"),
         "operator_pull_busy_share": op["busy_share"],
         "herd_launches": {"origin": hc["origin_launches"]["sha256_ragged"],
                           "agent": hc["agent_launches"]["sha256_ragged"]},
         "herd_verify_batches": hc["agent_cuda_batches"],
         "herd_rows_per_batch": hc["agent_verified_pieces"] / hc["agent_cuda_batches"],
         "shards_rows_per_launch": sh["rows_per_launch"],
         "herd_origin_dedup_chunks": hc["origin_dedup_chunks"],
         "front_door_launches": {"origin": fc["origin_launches"]["sha256_ragged"],
                                 "agent": fc["agent_launches"]["sha256_ragged"]},
         "front_door_verify_batches": fc["agent_cuda_batches"],
         "front_door_rows_per_batch": fc["agent_verified_pieces"] / fc["agent_cuda_batches"],
         "front_door_second_pull_launches": fc["second_pull_agent_launches"]["sha256_ragged"],
         **sha_entry(rag_main, ROWS_KERNEL)},
        {"name": "pack_tiles_device", "route": "cuda",
         "source": "kraken_tpu_torch/csrc/sha256_packed.cu",
         "replaces": "kraken_tpu/ops/sha256_pallas.py:321",
         "launches": ingest_launches["pack_tiles_device"], "max_abs_err": 0,
         "ms": pack_ms, "plain_ms": pack_plain_ms, "bound_ms": pack_bound_ms,
         "bound_by": pack_bound_by, "library_ms": pack_library_ms,
         "origin_http_launches": origin_launches("pack_tiles_device"), "delta_launches": delta_launches("pack_tiles_device"),
         "operator_launches": operator_launches("pack_tiles_device"),
         "shards_launches": shards_launches("pack_tiles_device"),
         "backends_launches": backends_launches("pack_tiles_device"),
         "shape": "1024 x 4 MiB", "plain_shape": "1024 x 4 MiB"},
        {"name": "sha256_packed_tiles", "route": "cuda",
         "source": "kraken_tpu_torch/csrc/sha256_packed.cu",
         "replaces": "kraken_tpu/ops/sha256_pallas.py:251",
         "launches": ingest_launches["sha256_packed_tiles"], "max_abs_err": 0,
         "ms": packed_ms, "plain_ms": packed_plain_ms, "library_ms": None,
         "shape": "1024 x 4 MiB", "plain_shape": "1024 x 16 KiB",
         "ms_at_plain_shape": packed16_ms,
         "origin_http_launches": origin_launches("sha256_packed_tiles"), "delta_launches": delta_launches("sha256_packed_tiles"),
         "operator_launches": operator_launches("sha256_packed_tiles"),
         "shards_launches": shards_launches("sha256_packed_tiles"),
         "backends_launches": backends_launches("sha256_packed_tiles"),
         **sha_entry(packed_main, PACKED_KERNEL)},
        {"name": "gear_candidates", "kernel": GEAR_KERNEL, "route": "cuda",
         "source": "kraken_tpu_torch/csrc/gear.cu",
         "replaces": "kraken_tpu/ops/cdc_pallas.py:81",
         "launches": dedup_launches["gear_candidates"], "max_abs_err": gear_err,
         "ms": gear_ms, "plain_ms": gear_plain_ms, "bound_ms": gear_leg["bound_ms"],
         "bound_by": gear_leg["bound_by"], "ops_bound_ms": gear_leg["ops_bound_ms"],
         "bytes_bound_ms": gear_leg["bytes_bound_ms"], "library_ms": gear_library_ms,
         "sass_per_byte": gear_sass,
         "origin_http_launches": origin_launches("gear_candidates"), "delta_launches": delta_launches("gear_candidates"),
         "operator_launches": operator_launches("gear_candidates"),
         "shards_launches": shards_launches("gear_candidates"),
         "backends_launches": backends_launches("gear_candidates"),
         "herd_launches": {"origin": hc["origin_launches"]["gear_candidates"],
                           "agent": hc["agent_launches"]["gear_candidates"]},
         "front_door_launches": {"origin": fc["origin_launches"]["gear_candidates"],
                                 "agent": fc["agent_launches"]["gear_candidates"]},
         "shape": "one 64 MiB window", "plain_shape": "one 64 MiB window"},
        # A diagnostic on no path of the system: the main path launches it
        # no time; each decomposition's own launches stand beside.
        {"name": "transpose_only", "route": "cuda", "source": "kraken_tpu_torch/csrc/transpose.cu",
         "replaces": "bench_transpose.py:80", "launches": main_launches["transpose_only"],
         "relayout_launches": relayout_launches,
         "origin_http_launches": origin_launches("transpose_only"), "delta_launches": delta_launches("transpose_only"),
         "operator_launches": operator_launches("transpose_only"),
         "shards_launches": shards_launches("transpose_only"),
         "backends_launches": backends_launches("transpose_only"), "max_abs_err": t_err,
         "ms": full["transpose_only_ms"], "plain_ms": full["transpose_only_plain_ms"],
         "bound_ms": t_bound["bound_ms"], "bound_by": t_bound["bound_by"], "library_ms": None,
         "shape": f"{FULL_TILES} x 1024 x 64 KiB", "plain_shape": f"{FULL_TILES} x 1024 x 64 KiB",
         "ms_at_bench_shape": decomps["bench_shape"]["transpose_only_ms"]},
    ], "main_path_seconds": main_secs, "ingest_seconds": ingest_secs,
        "dedup_seconds": dedup_secs, "swarm_seconds": swarm_secs,
        "tracker_seconds": tracker_secs, "origin_http_seconds": origin_secs,
        "herd_seconds": herd_secs, "front_door_seconds": front_secs,
        "delta_seconds": delta_secs, "operator_seconds": operator_secs,
        "shards_seconds": shards_secs, "backends_seconds": backends_secs,
        "parallel_seconds": parallel_secs,
        "int_ops_per_s": card.int_ops_per_s, "sm_clock_hz": card.sm_clock_hz})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
