"""The plain reference that decides ``correct``: NumPy and ``hashlib``
only. It imports nothing of ``kraken_tpu_torch`` (nor of the JAX package),
takes nothing the program made, and works every expected answer out of
the seeded bytes that ``portbench.traffic`` hands to both sides."""
