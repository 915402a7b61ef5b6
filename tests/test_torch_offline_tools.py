"""The port's offline subcommands (``testfs``, ``scrub``, ``fsck``,
``locate``; ``lint`` is in ``test_torch_lint.py``) held against the
reference's CLI: the same store trees (copied, mtimes kept) give the same
exit codes and the same JSON lines, and leave the same trees."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import kraken_tpu.cli as jax_cli
import kraken_tpu_torch as kt
import kraken_tpu_torch.cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = {"port": port_cli, "jax": jax_cli}


def call(pkg: str, args: list, capsys) -> tuple[int, list]:
    """One in-process run of ``main``: its exit code (0 for a plain
    return) and its stdout as JSON documents."""
    capsys.readouterr()
    try:
        CLI[pkg].main(args)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    out = capsys.readouterr().out
    return code, [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def tree(root) -> dict:
    """Every file under ``root`` and its bytes; the clean-shutdown stamp
    (``clean``, the time of the run) by its presence."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            with open(p, "rb") as f:
                out[rel] = f.read() if rel != "clean" else b"<stamp>"
    return out


def make_store(root, blobs: int = 3, seed: int = 0) -> list:
    store = kt.CAStore(str(root))
    rng = np.random.default_rng(seed)
    digests = []
    for i in range(blobs):
        data = rng.bytes(1000 + 777 * i)
        d = kt.Digest.from_bytes(data)
        uid = store.create_upload()
        store.write_upload_chunk(uid, 0, data)
        store.commit_upload(uid, d)
        digests.append(d)
    return digests


def both(tmp_path, run_name: str, src, args_of, capsys) -> tuple:
    """Run each package's CLI on its own copy of ``src``."""
    got = {}
    for pkg in ("jax", "port"):
        copy = tmp_path / run_name / pkg
        shutil.copytree(src, copy, copy_function=shutil.copy2)
        code, docs = call(pkg, args_of(str(copy)), capsys)
        got[pkg] = (code, docs, tree(copy))
    assert got["port"] == got["jax"]
    return got["port"]


# -- scrub ---------------------------------------------------------------------------


def test_scrub_clean_corrupt_and_missing_root(tmp_path, capsys):
    src = tmp_path / "store"
    digests = make_store(src)
    code, docs, _ = both(tmp_path, "clean", src, lambda r: ["scrub", "--store", r], capsys)
    assert (code, docs) == (0, [{"event": "scrub_done", "checked": 3, "corrupt": 0}])

    victim = kt.CAStore(str(src)).cache_path(digests[1])
    with open(victim, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 1]))
    code, docs, _ = both(tmp_path, "flipped", src, lambda r: ["scrub", "--store", r], capsys)
    assert code == 1
    assert docs[0]["event"] == "corrupt" and docs[0]["digest"] == digests[1].hex
    assert docs[-1] == {"event": "scrub_done", "checked": 3, "corrupt": 1}

    for pkg in ("jax", "port"):
        assert call(pkg, ["scrub", "--store", str(tmp_path / "nope")], capsys) == (
            2, [{"event": "error", "message": f"store root does not exist: {tmp_path / 'nope'}"}])
    assert not (tmp_path / "nope").exists()


def test_scrub_tool_in_process(tmp_path, capsys):
    digests = make_store(tmp_path / "s", blobs=2, seed=4)
    assert port_cli.run_scrub_tool(str(tmp_path / "s")) == 0
    assert json.loads(capsys.readouterr().out) == {"event": "scrub_done", "checked": 2,
                                                    "corrupt": 0}
    with open(kt.CAStore(str(tmp_path / "s")).cache_path(digests[0]), "ab") as f:
        f.write(b"!")
    assert port_cli.run_scrub_tool(str(tmp_path / "s")) == 1
    corrupt, summary = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert corrupt["event"] == "corrupt" and corrupt["digest"] == digests[0].hex
    assert summary == {"event": "scrub_done", "checked": 2, "corrupt": 1}


# -- fsck ----------------------------------------------------------------------------


def _fsck(*extra):
    return lambda r: ["fsck", "--root", r, *extra]


def test_fsck_clean_repaired_quarantined_and_usage(tmp_path, capsys):
    src = tmp_path / "store"
    digests = make_store(src, seed=1)
    # First pass on a hand-built store: no clean stamp yet, so it stamps.
    first = both(tmp_path, "first", src, _fsck(), capsys)
    assert first[0] in (0, 1) and first[1][-1]["event"] == "fsck_done"
    # Stamp the source itself (the port's tool), then a pass is clean.
    assert call("port", ["fsck", "--root", str(src)], capsys)[0] in (0, 1)
    code, docs, _ = both(tmp_path, "clean", src, _fsck(), capsys)
    assert code == 0 and docs == [{"event": "fsck_done", "repairs": {}, "quarantined": [],
                                   "verified": docs[0]["verified"], "exit_code": 0}]

    # Debris: an abandoned upload spool, old enough to sweep.
    spool = src / "upload" / "0123abcd-dead-beef-0000-000000000000"
    spool.write_bytes(b"half an upload")
    old = time.time() - 3600
    os.utime(spool, (old, old))
    code, docs, after = both(tmp_path, "debris", src, _fsck("--upload-ttl", "60"), capsys)
    assert code == 1 and sum(docs[-1]["repairs"].values()) >= 1
    assert not any(k.startswith("upload/0123abcd") for k in after)
    spool.unlink()

    # A torn blob, found by a full verify: quarantined, exit 2.
    victim = kt.CAStore(str(src)).cache_path(digests[0])
    with open(victim, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x01\x02")
    code, docs, after = both(tmp_path, "torn", src, _fsck("--verify", "all"), capsys)
    assert code == 2 and docs[-1]["quarantined"] == [digests[0].hex]
    assert any(k.startswith("quarantine/") for k in after)

    for pkg in ("jax", "port"):
        code, docs = call(pkg, ["fsck", "--root", str(tmp_path / "nope")], capsys)
        assert (code, docs[0]["event"]) == (3, "error")


# -- locate --------------------------------------------------------------------------


@pytest.mark.parametrize("members,max_replica", [(1, 3), (3, 3), (5, 2), (8, 3)])
def test_locate_places_as_the_reference(members, max_replica, capsys):
    addrs = ",".join(f"10.0.0.{i}:7610" for i in range(1, members + 1))
    for seed in range(4):
        d = kt.Digest.from_bytes(np.random.default_rng(seed).bytes(64))
        args = ["locate", "--cluster", addrs, "--digest", str(d), "--max-replica",
                str(max_replica)]
        port = call("port", args, capsys)
        assert port == call("jax", args, capsys)
        assert port[0] == 0 and len(port[1][0]["replicas"]) == min(members, max_replica)
        assert port_cli.locate(addrs.split(","), d.hex, max_replica) == port[1][0]


def test_locate_needs_a_cluster(capsys):
    for pkg in ("jax", "port"):
        with pytest.raises(SystemExit) as e:
            CLI[pkg].main(["locate", "--cluster", ",", "--digest", "0" * 64])
        assert e.value.code == 2


# -- testfs --------------------------------------------------------------------------


def _testfs(pkg: str) -> tuple:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", f"{pkg}.cli", "testfs", "--port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), proc.stderr.read()
        ready = json.loads(line[6:])
        import urllib.request

        url = f"http://{ready['addr']}/files/some/name"
        req = urllib.request.Request(url, data=b"stored bytes", method="PUT")
        with urllib.request.urlopen(req, timeout=30) as r:
            put = r.status
        proc.send_signal(signal.SIGHUP)
        time.sleep(0.3)
        alive_after_hup = proc.poll() is None
        with urllib.request.urlopen(url, timeout=30) as r:
            body = r.read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return sorted(ready), ready["component"], put, alive_after_hup, body, rc


def test_testfs_prints_ready_ignores_sighup_and_exits_0_on_sigterm():
    port = _testfs("kraken_tpu_torch")
    assert port == _testfs("kraken_tpu")
    assert port == (["addr", "component"], "testfs", 201, True, b"stored bytes", 0)
