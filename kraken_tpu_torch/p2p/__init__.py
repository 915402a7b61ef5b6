"""The P2P plane: the wire protocol, conns, the per-torrent dispatcher,
peer exchange, the scheduler, and torrent storage with batched piece
verification on the card.

Mirrors ``kraken_tpu.p2p`` (uber/kraken ``lib/torrent/*``, SURVEY.md
SS2.2): the swarm that fans a blob out through a dynamically formed peer
mesh with piece-level pipelining. The public surface is
``Scheduler.download(namespace, digest)`` plus seeding-by-existence for
origins, on one asyncio event loop. The frames equal the JAX package's
byte for byte, so peers of the two packages pull from each other.
"""
