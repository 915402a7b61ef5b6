"""The port's herd as processes: ``python -m kraken_tpu_torch.cli`` runs a
tracker, an origin and an agent built from the shipped ``config/`` files on
the ``cpu`` hasher; a blob uploaded to the origin comes back byte-identical
through the agent's HTTP API; a herd mixed with the JAX package's tracker
does the same; SIGHUP reloads the agent's scheduler section (and a reload
that raises keeps the current config); SIGTERM drains every node to exit 0;
a node that cannot have its hasher exits before its READY line.

Each child's port is 0 (the kernel picks one), its store a temp dir: the
development files' fixed ports and relative stores are overridden by flags.
"""

import asyncio
import contextlib
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "config"
BLOB = 300_000


@contextlib.contextmanager
def herd():
    """Owns spawned processes; on exit SIGTERM + wait, SIGKILL after 15 s."""
    procs: list[subprocess.Popen] = []
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def spawn(procs, pkg: str, args: list[str], err: Path, env=None) -> dict:
    """Start ``python -m <pkg>.cli <args>`` and return its READY document;
    on death before READY raise with its stderr."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cli", *args],
        stdout=subprocess.PIPE, stderr=open(err, "w"), cwd=REPO, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **(env or {})),
    )
    procs.append(proc)
    for line in proc.stdout:
        if line.startswith("READY "):
            return json.loads(line[6:])
    proc.wait(timeout=15)
    raise RuntimeError(f"{args[0]} died before READY ({proc.returncode}):\n"
                       + err.read_text()[-3000:])


def port_of(addr: str) -> str:
    return addr.rsplit(":", 1)[1]


def start_herd(procs, tmp_path, tracker_pkg: str = "kraken_tpu_torch"):
    """Tracker, origin, agent from the shipped development files. The
    tracker needs the origin's address, so it is respawned on its port
    once the origin is up (the reference herd's dance)."""
    tracker_args = (["--config", str(CONFIG / "tracker/development.yaml")]
                    if tracker_pkg == "kraken_tpu_torch" else [])
    t = spawn(procs, tracker_pkg, ["tracker", *tracker_args, "--port", "0"], tmp_path / "t0.err")
    o = spawn(procs, "kraken_tpu_torch", [
        "origin", "--config", str(CONFIG / "origin/development.yaml"), "--port", "0",
        "--p2p-port", "0", "--store", str(tmp_path / "origin"), "--tracker", t["addr"],
    ], tmp_path / "o.err")
    first = procs.pop(0)
    first.send_signal(signal.SIGTERM)
    assert first.wait(timeout=15) == 0
    t = spawn(procs, tracker_pkg, ["tracker", *tracker_args, "--port", port_of(t["addr"]),
                                   "--origins", o["addr"]], tmp_path / "t.err")
    a = spawn(procs, "kraken_tpu_torch", [
        "agent", "--config", str(CONFIG / "agent/development.yaml"), "--port", "0",
        "--p2p-port", "0", "--store", str(tmp_path / "agent"), "--tracker", t["addr"],
    ], tmp_path / "a.err")
    return t, o, a


def metric(text: str, name: str, **labels) -> float:
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    pat = re.compile(rf"^{name}(?:\{{{re.escape(want)}\}})? (\S+)$", re.M) if labels else \
        re.compile(rf"^{name} (\S+)$", re.M)
    m = pat.search(text)
    return float(m.group(1)) if m else 0.0


async def pull_through(t: dict, o: dict, a: dict, blob: bytes) -> dict:
    from kraken_tpu_torch.core.digest import Digest
    from kraken_tpu_torch.core.metainfo import MetaInfo
    from kraken_tpu_torch.origin.client import BlobClient
    from kraken_tpu_torch.utils.httputil import HTTPClient

    d = Digest.from_bytes(blob)
    oc = BlobClient(o["addr"])
    http = HTTPClient(timeout_seconds=60)
    try:
        await oc.upload("library/herd", d, blob)
        got = await http.get(f"http://{a['addr']}/namespace/library%2Fherd/blobs/{d.hex}")
        mi = MetaInfo.deserialize(await http.get(
            f"http://{t['addr']}/namespace/library%2Fherd/blobs/{d.hex}/metainfo"))
        return {
            "same": got == blob, "digest": d, "metainfo": mi,
            "agent": (await http.get(f"http://{a['addr']}/metrics")).decode(),
            "origin": (await http.get(f"http://{o['addr']}/metrics")).decode(),
        }
    finally:
        await oc.close()
        await http.close()


def hashlib_pieces(blob: bytes, piece: int) -> bytes:
    return b"".join(hashlib.sha256(blob[i:i + piece]).digest()
                    for i in range(0, len(blob), piece))


def stop_all(procs) -> list[int]:
    for p in procs:
        p.send_signal(signal.SIGTERM)
    return [p.wait(timeout=40) for p in procs]


def test_the_shipped_development_files_boot_a_port_herd_that_pulls_and_drains(tmp_path):
    blob = np.random.default_rng(21).integers(0, 256, BLOB, dtype=np.uint8).tobytes()
    with herd() as procs:
        t, o, a = start_herd(procs, tmp_path)
        r = asyncio.run(pull_through(t, o, a, blob))
        codes = stop_all(procs)
    assert r["same"]
    mi = r["metainfo"]
    assert mi.digest == r["digest"] and mi.piece_hashes == hashlib_pieces(blob, mi.piece_length)
    assert metric(r["agent"], "verify_batches_total", path="host") >= 1
    assert metric(r["agent"], "verify_batches_total", path="cuda") == 0
    assert metric(r["origin"], "hasher_pieces_total", hasher="cpu") >= mi.num_pieces
    assert codes == [0, 0, 0]
    for name in ("t.err", "o.err", "a.err"):
        log = (tmp_path / name).read_text()
        assert "drain quiesced" in log, log[-2000:]
        assert '"level": "error"' not in log, log[-2000:]


def test_a_mixed_herd_with_the_jax_tracker_pulls_byte_identical(tmp_path):
    blob = np.random.default_rng(22).integers(0, 256, BLOB, dtype=np.uint8).tobytes()
    with herd() as procs:
        t, o, a = start_herd(procs, tmp_path, tracker_pkg="kraken_tpu")
        r = asyncio.run(pull_through(t, o, a, blob))
        codes = stop_all(procs)
    assert r["same"] and r["metainfo"].digest == r["digest"]
    assert codes == [0, 0, 0]


def _wait_for(path: Path, needle: str, timeout: float = 20.0) -> str:
    deadline = time.time() + timeout
    while time.time() < deadline:
        text = path.read_text()
        if needle in text:
            return text
        time.sleep(0.1)
    raise AssertionError(f"{needle!r} never appeared:\n" + path.read_text()[-2000:])


def test_sighup_reloads_the_agents_scheduler_and_a_bad_reload_keeps_the_config(tmp_path):
    cfg = tmp_path / "agent.yaml"
    base = f"extends: {CONFIG}/agent/development.yaml\nscheduler:\n  wire_send_batch: "
    cfg.write_text(base + "16\n")
    err = tmp_path / "a.err"
    with herd() as procs:
        spawn(procs, "kraken_tpu_torch", [
            "agent", "--config", str(cfg), "--port", "0", "--p2p-port", "0",
            "--store", str(tmp_path / "a"), "--tracker", "127.0.0.1:1"], err)
        cfg.write_text(base + "8\n")
        procs[0].send_signal(signal.SIGHUP)
        log = _wait_for(err, '"wire_send_batch": 8')
        assert "scheduler config reloaded" in log
        cfg.write_text(base + "4\ndelta:\n  enabled: true\n")
        procs[0].send_signal(signal.SIGHUP)
        log = _wait_for(err, "keeping current config")
        assert "A7f" in log and '"wire_send_batch": 4' not in log
        assert stop_all(procs) == [0]


def test_a_node_that_cannot_have_its_hasher_exits_before_ready(tmp_path):
    """The shipped base files ask for ``hasher: tpu`` (refused, naming the
    port's hashers); a ``cuda`` node without a card fails its boot."""
    for name, args, env in (
        ("tpu", ["--config", str(CONFIG / "agent/base.yaml")], {}),
        ("cuda", ["--hasher", "cuda"], {"CUDA_VISIBLE_DEVICES": ""}),
    ):
        err = tmp_path / f"{name}.err"
        proc = subprocess.run(
            [sys.executable, "-m", "kraken_tpu_torch.cli", "agent", *args, "--port", "0",
             "--p2p-port", "0", "--store", str(tmp_path / name), "--tracker", "127.0.0.1:1"],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO), **env),
        )
        err.write_text(proc.stderr)
        assert proc.returncode != 0 and "READY" not in proc.stdout, name
        assert ("'cuda'" in proc.stderr and "A4" in proc.stderr) if name == "tpu" \
            else "CUDA" in proc.stderr
