"""GPU compute plane: batched SHA-256 (a hand-written CUDA kernel for
Hopper plus its plain PyTorch version).

The counterpart of ``kraken_tpu.ops``. Only the piece-hash plane is ported
so far; FastCDC and MinHash wait for the dedup slice (ROADMAP.md).
"""
