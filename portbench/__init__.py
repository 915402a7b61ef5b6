"""The benchmark of ``kraken_tpu_torch``, the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card and prints one JSON line::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by name:

- ``configs/<config>.json``: the deployment as it is run;
- ``traffic/<mix>.json``: the parameters of a mix, naming its driver;
- ``drivers/<driver>.py``: sets the system up, drives the window, and
  hands the readers what it observed;
- ``metrics/<metric>.py``: a reader, ``read(obs) -> float | None``.

``reference/`` holds the plain reference (NumPy and ``hashlib``) that
decides ``correct``. Nothing here imports JAX or the JAX package.
"""
