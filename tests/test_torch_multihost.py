"""The port's multi-host hash plane (``kraken_tpu_torch.parallel.multihost``)
in real processes on the CPU: N ranks join a gloo process group over
localhost, each hashes its own batch on a CPU shard, and the digests are
gathered. Every rank's global matrix must equal hashlib over every batch,
and the reference's ``kraken_tpu.parallel.multihost`` on the same batches
must give the same matrix.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PLEN = 256

# The reference's rank: join, hash the self-test's batch, print the SHA-256
# of the global digest matrix.
_JAX_RANK = r"""
import hashlib, sys
import numpy as np
from kraken_tpu.parallel.multihost import init_multihost, multihost_hash_pieces
p, n, port = map(int, sys.argv[1:4])
init_multihost(f"127.0.0.1:{port}", n, p)
rng = np.random.default_rng(1000 + p)
batch = rng.integers(0, 256, size=(3 + p, 256), dtype=np.uint8)
got = multihost_hash_pieces(batch, 256)
print("GLOBAL", hashlib.sha256(got.tobytes()).hexdigest(), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argv_of, n: int, env: dict) -> list[str]:
    """Start ``n`` ranks at once; every one must exit 0 within 120 s."""
    port = _free_port()
    procs = [
        subprocess.Popen(argv_of(p, n, port), cwd=REPO, env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(n)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, f"rc={proc.returncode}\n{out}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _want(n: int) -> bytes:
    """hashlib over every rank's batch, in rank order."""
    return b"".join(
        hashlib.sha256(row.tobytes()).digest()
        for p in range(n)
        for row in np.random.default_rng(1000 + p).integers(
            0, 256, size=(3 + p, PLEN), dtype=np.uint8)
    )


@pytest.mark.parametrize("n", [2, 3])
def test_the_gathered_digests_equal_hashlib_and_the_references(n):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    outs = _run_ranks(
        lambda p, n, port: [sys.executable, "-m", "kraken_tpu_torch.parallel.multihost",
                            str(p), str(n), str(port), "--platform", "cpu"],
        n, env)
    want = hashlib.sha256(_want(n)).hexdigest()
    digests = sum(3 + p for p in range(n))
    for p, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith("MULTIHOST-OK"))
        assert line.startswith(f"MULTIHOST-OK proc={p} digests={digests} "), line
        stats = json.loads(line.split(" ", 3)[3])
        assert stats["global_sha256"] == want and stats["piece_length"] == PLEN
        assert not any(stats["launches"].values())  # CPU shards launch nothing
    ref = _run_ranks(
        lambda p, n, port: [sys.executable, "-c", _JAX_RANK, str(p), str(n), str(port)],
        n, env)
    assert [out.split("GLOBAL ", 1)[1].split()[0] for out in ref] == [want] * n


def test_a_rank_without_the_card_raises_naming_the_cpu(monkeypatch):
    """``multihost_hash_pieces`` with no context takes the card's devices,
    and raises before it touches the process group when there is none."""
    import torch

    from kraken_tpu_torch.parallel.multihost import MultihostContext, multihost_hash_pieces

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = np.zeros((3, PLEN), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        multihost_hash_pieces(batch, PLEN)
    with pytest.raises(RuntimeError, match="platform='cpu'"):
        MultihostContext.current()
