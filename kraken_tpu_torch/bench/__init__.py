"""Benchmarks of the port that measure a kernel apart from any path of the
system: :mod:`~kraken_tpu_torch.bench.transpose`, the counterpart of
``bench_transpose.py``.
"""
