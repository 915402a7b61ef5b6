"""The port's herd as processes: ``python -m kraken_tpu_torch.cli`` runs a
tracker, an origin and an agent built from the shipped ``config/`` files on
the ``cpu`` hasher; a blob uploaded to the origin comes back byte-identical
through the agent's HTTP API; a herd mixed with the JAX package's tracker
does the same; SIGHUP reloads the agent's scheduler section (and a reload
that raises keeps the current config); SIGTERM drains every node to exit 0;
a node that cannot have its hasher exits before its READY line. The five
components together: an image pushed through the proxy comes back by tag
through the agent's registry endpoint, and a proxy killed mid-push resumes
the upload session from its durable spool.

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
import socket
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


def stop_all(procs, sig=signal.SIGTERM) -> list[int]:
    for p in procs:
        p.send_signal(sig)
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


def _wait_for_count(path: Path, needle: str, count: int, timeout: float = 20.0) -> None:
    deadline = time.time() + timeout
    while path.read_text().count(needle) < count:
        if time.time() > deadline:
            raise AssertionError(f"{needle!r} not {count} times:\n" + path.read_text()[-2000:])
        time.sleep(0.1)


def test_sighup_reloads_the_agents_scheduler_and_a_bad_reload_keeps_the_config(tmp_path):
    """A SIGHUP applies the scheduler section live, worker counts
    included (the agent forks its two seed-serve workers); a section the
    reader refuses keeps the current config whole."""
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
        cfg.write_text(base + "4\n  data_plane_workers: 2\n")
        procs[0].send_signal(signal.SIGHUP)
        log = _wait_for(err, '"wire_send_batch": 4')
        assert '"data_plane_workers": 2' in log
        _wait_for_count(err, "data-plane shard spawned", 2)
        cfg.write_text(base + "2\n  data_plane_workers: 2\n  no_such_knob: 1\n")
        procs[0].send_signal(signal.SIGHUP)
        log = _wait_for(err, "keeping current config")
        assert "no_such_knob" in log and '"wire_send_batch": 2' not in log
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


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def spawn_all(procs, specs: dict, err_dir: Path) -> dict:
    """``spawn`` for several children at once, each on a port picked
    beforehand, so that no child waits for another's READY: ``specs``
    maps a name to its CLI arguments (stderr to ``<name>.err``); returns
    each READY document."""
    started = {}
    for name, args in specs.items():
        started[name] = subprocess.Popen(
            [sys.executable, "-m", "kraken_tpu_torch.cli", *args],
            stdout=subprocess.PIPE, stderr=open(err_dir / f"{name}.err", "w"), cwd=REPO,
            text=True, env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu"),
        )
        procs.append(started[name])
    ready = {}
    for name, proc in started.items():
        for line in proc.stdout:
            if line.startswith("READY "):
                ready[name] = json.loads(line[6:])
                break
        else:
            proc.wait(timeout=15)
            raise RuntimeError(f"{name} died before READY ({proc.returncode}):\n"
                               + (err_dir / f"{name}.err").read_text()[-3000:])
    return ready


def front_door_specs(tmp_path, spool=None, components=("t", "o", "bi", "px", "a")) -> dict:
    """The five components from the shipped files, addresses as flags:
    tracker, origin and agent from their development files, the
    build-index and the proxy from their base files."""
    ports = dict(zip(("t", "o", "bi", "px", "a"), free_ports(5)))
    addr = {k: f"127.0.0.1:{p}" for k, p in ports.items()}
    specs = {
        "t": ["tracker", "--config", str(CONFIG / "tracker/development.yaml"),
              "--origins", addr["o"]],
        "o": ["origin", "--config", str(CONFIG / "origin/development.yaml"),
              "--p2p-port", "0", "--store", str(tmp_path / "origin"), "--tracker", addr["t"]],
        "bi": ["build-index", "--config", str(CONFIG / "build-index/base.yaml"),
               "--store", str(tmp_path / "bi"), "--origins", addr["o"]],
        "px": ["proxy", "--config", str(CONFIG / "proxy/base.yaml"),
               "--origins", addr["o"], "--build-index", addr["bi"]]
        + (["--spool", str(spool)] if spool is not None else []),
        "a": ["agent", "--config", str(CONFIG / "agent/development.yaml"),
              "--p2p-port", "0", "--store", str(tmp_path / "agent"), "--tracker", addr["t"],
              "--registry-port", "0", "--build-index", addr["bi"]],
    }
    return {k: [*specs[k], "--port", str(ports[k])] for k in components}


def test_five_processes_push_through_the_proxy_and_pull_by_tag_through_the_agent(tmp_path):
    """``tests/test_herd_process.py::test_process_herd_full_five_components``
    on the port: every component a CLI process."""
    from kraken_tpu_torch.utils import http_lite
    from test_torch_registry import make_image, pull_image, push_image

    config, layers, manifest = make_image(nlayers=2, layer_size=120_000, seed=31)
    with herd() as procs:
        ready = spawn_all(procs, front_door_specs(tmp_path), tmp_path)
        bi, px, a = ready["bi"], ready["px"], ready["a"]
        assert a.get("registry_addr"), a

        async def drive():
            async with http_lite.ClientSession() as s:
                pushed = await push_image(s, px["addr"], "library/app", "v1", config, layers,
                                          manifest)
                got = await pull_image(s, a["registry_addr"], "library/app", "v1")
                async with s.request("GET", f"http://{bi['addr']}/tags/library%2Fapp%3Av1") as r:
                    tag = await r.text()
            return pushed, got, tag

        pushed, (got_manifest, got_blobs), tag = asyncio.run(drive())
        # SIGINT: the clean stop without the drain's wait for idle conns
        # (the drain has its own test above).
        codes = stop_all(procs, signal.SIGINT)
    assert got_manifest == manifest and set(got_blobs.values()) == {config, *layers}
    assert tag == pushed
    assert codes == [0, 0, 0, 0, 0]
    for name in ("t", "o", "bi", "px", "a"):
        log = (tmp_path / f"{name}.err").read_text()
        assert '"level": "error"' not in log and "node reads" not in log, log[-2000:]


def test_proxy_crash_resumes_upload_session(tmp_path):
    """``tests/test_herd_process.py::test_proxy_crash_resumes_upload_session``
    on the port: SIGKILL the proxy mid-push, restart it on its port and
    spool, and the client resumes the same session to a byte-identical
    blob; an unknown session still answers the spec's code."""
    from kraken_tpu_torch.core.digest import Digest as PortDigest
    from kraken_tpu_torch.utils import http_lite

    blob = np.random.default_rng(32).integers(0, 256, 600_000, dtype=np.uint8).tobytes()
    half = len(blob) // 2
    d = PortDigest.from_bytes(blob)
    specs = front_door_specs(tmp_path, spool=tmp_path / "spool", components=("o", "bi", "px"))
    with herd() as procs:
        ready = spawn_all(procs, specs, tmp_path)
        proxy = procs[-1]
        base = f"http://{ready['px']['addr']}"

        async def drive():
            async with http_lite.ClientSession() as s:
                async with s.request("POST", f"{base}/v2/library/app/blobs/uploads/") as r:
                    assert r.status == 202
                    loc = r.headers["Location"]
                async with s.request("PATCH", base + loc, data=blob[:half]) as r:
                    assert r.status == 202
                proxy.kill()
                proxy.wait(timeout=10)
                procs.remove(proxy)
                spawn_all(procs, {"px2": specs["px"]}, tmp_path)
                out = {}
                async with s.request("GET", base + loc) as r:
                    out["status"] = (r.status, r.headers.get("Range"))
                async with s.request("PATCH", base + loc, data=blob[half:]) as r:
                    out["resume"] = (r.status, r.headers.get("Range"))
                async with s.request("PUT", f"{base}{loc}?digest={d}") as r:
                    out["finish"] = r.status
                async with s.request("GET", f"{base}/v2/library/app/blobs/{d}") as r:
                    out["blob"] = (r.status, await r.read() == blob)
                async with s.request("PATCH", f"{base}/v2/library/app/blobs/uploads/nope",
                                     data=b"x") as r:
                    out["unknown"] = (r.status, json.loads(await r.read())["errors"][0]["code"])
            return out

        out = asyncio.run(drive())
    assert out == {"status": (204, f"0-{half - 1}"), "resume": (202, f"0-{len(blob) - 1}"),
                   "finish": 201, "blob": (200, True), "unknown": (404, "BLOB_UPLOAD_UNKNOWN")}
