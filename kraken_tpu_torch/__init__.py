"""kraken-tpu on PyTorch and CUDA: the port of ``kraken_tpu`` to an NVIDIA
H100.

The package mirrors ``kraken_tpu``'s layout (``core``, ``ops``, ``store``,
``origin``, ``p2p``, ``utils``) so each module's counterpart is easy to
find, and imports nothing of it: ``kraken_tpu`` is the reference the port is
tested against, bit for bit. Every TPU kernel on a ported path becomes a
kernel written by hand for Hopper (``csrc/``).

Ported so far: the piece-hash plane -- an origin generates a blob's
MetaInfo (``origin.metainfogen.Generator``) and an agent verifies every
received piece (``p2p.storage.BatchedVerifier``), both through the ``cuda``
hasher (``ops.sha256.TorchPieceHasher``) and its SHA-256 kernel -- and the
pipelined ingest plane (``core.ingest.IngestPipeline``, which the
``Generator`` takes as ``pipeline=``): staging windows from a
``utils.bufpool.BufferPool``, the host packer (``native``), and the packed
path's two kernels (``csrc/sha256_packed.cu``) -- and the dedup plane
(``origin.dedup.DedupIndex``): FastCDC chunking through the gear kernel
(``ops.cdc``, ``csrc/gear.cu``), chunk fingerprints through the SHA-256
kernel, MinHash sketches and LSH indexes (``ops.minhash``) -- and the P2P
wire and swarm (``p2p.wire``, ``p2p.conn``, ``p2p.dispatch``, ``p2p.pex``,
``p2p.scheduler``): schedulers pull blobs from each other over TCP, each
agent verifying every received piece on the card, with the wire's headers
through the port's own MessagePack codec (``utils.msgpack_lite``) -- and
the tracker fleet (``tracker.server``, ``tracker.client``, ``placement``):
trackers and their clients over the port's own HTTP/1.1
(``utils.http_lite``), sharded by rendezvous hashing, failing over through
breakers and deadline budgets -- and the origin over that HTTP
(``origin.server.OriginServer``, ``origin.client``, ``backend``,
``persistedretry``, ``store.serve``): resumable uploads whose metainfo the
card makes, ranged downloads, a quorum write plane, heal, refresh and
writeback. Entry points run on the card unless the caller asks for the CPU
(a CPU hasher, ``device="cpu"``).
"""

from kraken_tpu_torch.core import (
    CPUPieceHasher,
    Digest,
    Digester,
    DigestError,
    InfoHash,
    MetaInfo,
    MetaInfoError,
    PieceHasher,
    get_hasher,
)
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.core.metainfo import ChunkRecipe
from kraken_tpu_torch.ops.cdc import CDCParams, chunk, chunk_host, chunk_spans
from kraken_tpu_torch.ops.minhash import CompactLSHIndex, LSHIndex, MinHasher
from kraken_tpu_torch.ops.sha256 import TorchPieceHasher
from kraken_tpu_torch.origin.dedup import ChunkSketchMetadata, DedupIndex
from kraken_tpu_torch.origin.metainfogen import (
    Generator,
    PieceLengthConfig,
    TorrentMetaMetadata,
)
from kraken_tpu_torch.p2p.storage import (
    AgentTorrentArchive,
    BatchedVerifier,
    OriginTorrentArchive,
    PieceError,
    Torrent,
)
from kraken_tpu_torch.store import CAStore, PieceStatusMetadata
from kraken_tpu_torch.utils.bufpool import BufferPool

__version__ = "0.1.0"

__all__ = [
    "AgentTorrentArchive",
    "BatchedVerifier",
    "BufferPool",
    "CAStore",
    "CDCParams",
    "ChunkRecipe",
    "ChunkSketchMetadata",
    "CompactLSHIndex",
    "CPUPieceHasher",
    "DedupIndex",
    "Digest",
    "Digester",
    "DigestError",
    "Generator",
    "InfoHash",
    "IngestConfig",
    "IngestPipeline",
    "LSHIndex",
    "MetaInfo",
    "MetaInfoError",
    "MinHasher",
    "OriginTorrentArchive",
    "PieceError",
    "PieceHasher",
    "PieceLengthConfig",
    "PieceStatusMetadata",
    "TorchPieceHasher",
    "Torrent",
    "TorrentMetaMetadata",
    "chunk",
    "chunk_host",
    "chunk_spans",
    "get_hasher",
]
