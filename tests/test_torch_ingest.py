"""The port's pipelined ingest plane (``kraken_tpu_torch.core.ingest``) on
the CPU, held against ``kraken_tpu.core.ingest`` and hashlib.

The ``cuda`` hasher runs on the CPU here (``TorchPieceHasher(device=
"cpu")``), so the packed path of ``pack_mode: native|device`` runs the
plain versions of its kernels. Pieces are 1024 bytes and windows 1 MiB,
so a full window is exactly one 1024-piece tile and takes the packed
path. Every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import kraken_tpu_torch as kt
from kraken_tpu.core.digest import Digest as JaxDigest
from kraken_tpu.core.hasher import get_hasher as jax_get_hasher
from kraken_tpu.core.ingest import IngestConfig as JaxIngestConfig
from kraken_tpu.core.ingest import IngestPipeline as JaxIngestPipeline
from kraken_tpu.origin import metainfogen as jax_mig
from kraken_tpu.store import CAStore as JaxCAStore
from kraken_tpu_torch.core.ingest import IngestConfig, IngestPipeline
from kraken_tpu_torch.ops import sha256_cuda
from kraken_tpu_torch.utils import failpoints
from kraken_tpu_torch.utils.metrics import REGISTRY

PLEN = 1024
WINDOW = 1 << 20  # one 1024-piece tile of 1024-byte pieces
MODES = ("host", "native", "device")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # One intra-op thread keeps this module from competing for every core
    # with the timing-band tests that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hasher():
    return kt.TorchPieceHasher(device="cpu")


@pytest.fixture
def packed_calls(monkeypatch):
    """Counts the packed path's wrapper calls (on the CPU they run the
    plain versions, so the launch counters stay at 0)."""
    calls = {"pack_tiles_device": 0, "sha256_packed_tiles": 0}
    for name in calls:
        real = getattr(sha256_cuda, name)

        def spy(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(sha256_cuda, name, spy)
    return calls


def _blob(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _stream(pipe, blob: bytes, plen: int = PLEN):
    ses = pipe.session(plen)
    off = 0
    while off < len(blob):
        buf = ses.begin_window()
        n = min(len(buf), len(blob) - off)
        buf[:n] = blob[off : off + n]
        off += n
        ses.submit(n)
    return ses, ses.finish()


def _upload(store, blob: bytes, d) -> None:
    uid = store.create_upload()
    store.write_upload_chunk(uid, 0, blob)
    store.commit_upload(uid, d)


def test_ingest_config_validation():
    """Unknown keys and out-of-range knobs fail loudly at parse time,
    never half-apply."""
    cfg = IngestConfig.from_dict(None)
    assert cfg.pack_mode == "host" and cfg.windows_in_flight == 2
    assert cfg == IngestConfig() and cfg.window_bytes == JaxIngestConfig().window_bytes
    with pytest.raises(ValueError):
        IngestConfig.from_dict({"widow_bytes": 1 << 20})  # typo'd key
    with pytest.raises(ValueError):
        IngestConfig(windows_in_flight=0)
    with pytest.raises(ValueError):
        IngestConfig(pack_mode="avx")
    with pytest.raises(ValueError):
        IngestConfig(window_bytes=4096)
    with pytest.raises(ValueError):
        IngestConfig(pack_workers=-1)
    assert IngestConfig.from_dict({"pack_mode": "device"}).pack_mode == "device"


@pytest.mark.parametrize("mode", MODES)
def test_ingest_session_bit_identity(hasher, packed_calls, mode):
    """The pipeline reorders WHEN pieces hash, never piece boundaries:
    digests equal kraken_tpu's pipeline and hashlib for empty,
    single-piece, ragged and multi-window blobs; in native and device mode
    every full window goes through the packed path."""
    cfg = dict(window_bytes=WINDOW, windows_in_flight=2, pack_mode=mode)
    pipe = IngestPipeline(hasher, IngestConfig(**cfg))
    jpipe = JaxIngestPipeline(jax_get_hasher("cpu"), JaxIngestConfig(**cfg))
    rng = np.random.default_rng(7)
    for total in (0, PLEN, 3 * PLEN + 1, 2 * WINDOW + 5 * PLEN + 99):
        blob = rng.integers(0, 256, size=total, dtype=np.uint8).tobytes()
        ses, got = _stream(pipe, blob)
        want = kt.CPUPieceHasher().hash_pieces(blob, PLEN)
        assert np.array_equal(got, want), f"total={total}"
        assert np.array_equal(_stream(jpipe, blob)[1], want), f"total={total}"
        if total:
            assert ses.windows >= 1 and ses.wall_seconds > 0
        assert not ses._fell_back
    assert pipe._bufpool.leased == 0
    full_windows = 2
    assert packed_calls == {
        "pack_tiles_device": full_windows if mode == "device" else 0,
        "sha256_packed_tiles": 0 if mode == "host" else full_windows,
    }
    if mode != "host":
        assert ses.stage_seconds["pack"] > 0


def test_pipeline_abort_returns_every_lease(hasher):
    """abort() mid-stream returns every BufferPool lease -- a leaked
    staging lease caps all future ingest concurrency."""
    pipe = IngestPipeline(
        hasher, IngestConfig(window_bytes=WINDOW, windows_in_flight=2)
    )
    ses = pipe.session(4096)
    buf = ses.begin_window()
    buf[:4096] = b"x" * 4096
    ses.submit(4096)
    ses.begin_window()  # second window leased, never submitted
    ses.abort()
    assert pipe._bufpool.leased == 0


def test_device_fault_falls_back_bit_identical(hasher, packed_calls):
    """A device-path fault reroutes the window and the rest of the stream
    to hashlib: digests stay bit-identical, the fallback is counted once."""
    pipe = IngestPipeline(
        hasher,
        IngestConfig(window_bytes=WINDOW, windows_in_flight=1, pack_mode="device"),
    )
    blob = _blob(2 * WINDOW + 3 * PLEN + 7, 11)
    counter = REGISTRY.counter("ingest_fallbacks_total")
    before = counter.value(reason="failpoint")
    failpoints.FAILPOINTS.arm("origin.ingest.device_fail", "once")
    try:
        ses, got = _stream(pipe, blob)
    finally:
        failpoints.FAILPOINTS.disarm_all()
    assert np.array_equal(got, kt.CPUPieceHasher().hash_pieces(blob, PLEN))
    assert ses._fell_back
    assert counter.value(reason="failpoint") == before + 1
    assert packed_calls == {"pack_tiles_device": 0, "sha256_packed_tiles": 0}
    assert pipe._bufpool.leased == 0


@pytest.fixture(scope="module")
def generated(tmp_path_factory, hasher):
    """A ~2.5 MiB blob: its MetaInfo from the port's serial Generator and
    from kraken_tpu's Generator with a kraken_tpu pipeline."""
    root = tmp_path_factory.mktemp("ingest-gen")
    blob = _blob(2 * WINDOW + WINDOW // 2 + 123, 3)
    table = ((0, PLEN),)
    serial_store = kt.CAStore(str(root / "serial"))
    d = kt.Digest.from_bytes(blob)
    _upload(serial_store, blob, d)
    serial = kt.Generator(
        serial_store, hasher=hasher, piece_lengths=kt.PieceLengthConfig(table)
    ).generate_sync(d)
    jstore = JaxCAStore(str(root / "jax"))
    jd = JaxDigest.from_bytes(blob)
    _upload(jstore, blob, jd)
    jpipe = JaxIngestPipeline(
        jax_get_hasher("cpu"), JaxIngestConfig(window_bytes=WINDOW)
    )
    jmi = jax_mig.Generator(
        jstore, piece_lengths=jax_mig.PieceLengthConfig(table), pipeline=jpipe
    ).generate_sync(jd)
    return root, blob, d, serial, jmi


@pytest.mark.parametrize("mode", MODES)
def test_pipelined_generate(generated, hasher, packed_calls, mode):
    """``Generator(..., pipeline=...)``: the MetaInfo bytes and info hash
    equal the port's serial Generator and kraken_tpu's pipelined one, and
    the plane's metrics render on the port's registry."""
    root, blob, d, serial, jmi = generated
    store = kt.CAStore(str(root / mode))
    _upload(store, blob, d)
    pipe = IngestPipeline(
        hasher, IngestConfig(window_bytes=WINDOW, windows_in_flight=2, pack_mode=mode)
    )
    windows = REGISTRY.counter("ingest_windows_total").value(hasher="cuda")
    gen = kt.Generator(store, piece_lengths=kt.PieceLengthConfig(((0, PLEN),)), pipeline=pipe)
    assert gen.hasher is hasher and gen.pipeline is pipe
    mi = gen.generate_sync(d)
    assert mi.num_pieces == len(blob) // PLEN + 1
    assert mi.serialize() == serial.serialize() == jmi.serialize()
    assert mi.info_hash.hex == serial.info_hash.hex == jmi.info_hash.hex
    assert store.get_metadata(d, kt.TorrentMetaMetadata).metainfo == mi
    assert REGISTRY.counter("ingest_windows_total").value(hasher="cuda") == windows + 3
    text = REGISTRY.render()
    assert 'ingest_windows_total{hasher="cuda"}' in text
    assert 'ingest_stage_seconds_bucket{stage="hash",le="0.001"}' in text
    assert packed_calls["sha256_packed_tiles"] == (0 if mode == "host" else 2)
    assert pipe._bufpool.leased == 0


def test_generate_read_fault_aborts_and_returns_leases(generated, hasher):
    """A staging-read fault mid-blob aborts the session: the error reaches
    the caller, no MetaInfo is persisted, every lease returns."""
    root, blob, d, _, _ = generated
    store = kt.CAStore(str(root / "read-fault"))
    _upload(store, blob, d)
    pipe = IngestPipeline(hasher, IngestConfig(window_bytes=WINDOW))
    gen = kt.Generator(store, piece_lengths=kt.PieceLengthConfig(((0, PLEN),)), pipeline=pipe)
    failpoints.FAILPOINTS.arm("ingest.window.read", "every:2")
    try:
        with pytest.raises(failpoints.FailpointError):
            gen.generate_sync(d)
    finally:
        failpoints.FAILPOINTS.disarm_all()
    assert gen.get_cached(d) is None
    assert pipe._bufpool.leased == 0


@pytest.mark.parametrize(
    "mode, module, kernel",
    [
        ("host", "kraken_tpu_torch.ops.sha256", "sha256_uniform"),
        ("device", "kraken_tpu_torch.ops.sha256_cuda", "pack_tiles_device"),
        ("native", "kraken_tpu_torch.ops.sha256_cuda", "sha256_packed_tiles"),
    ],
)
def test_kernel_error_fails_the_session_never_falls_back(
    generated, hasher, monkeypatch, mode, module, kernel
):
    """A kernel that cannot build or launch fails the session: the error
    reaches the caller, nothing is persisted, every lease returns, and
    the work is never rerouted to hashlib (only injected faults are)."""
    root, blob, d, _, _ = generated
    store = kt.CAStore(str(root / f"kernel-error-{mode}"))
    _upload(store, blob, d)

    def refused(*args, **kwargs):
        raise RuntimeError(f"{kernel}: launch refused")

    monkeypatch.setattr(f"{module}.{kernel}", refused)
    pipe = IngestPipeline(
        hasher, IngestConfig(window_bytes=WINDOW, windows_in_flight=2, pack_mode=mode)
    )
    gen = kt.Generator(store, piece_lengths=kt.PieceLengthConfig(((0, PLEN),)), pipeline=pipe)
    counter = REGISTRY.counter("ingest_fallbacks_total")
    before = counter.value(reason="failpoint")
    with pytest.raises(RuntimeError, match="launch refused"):
        gen.generate_sync(d)
    assert counter.value(reason="failpoint") == before
    assert gen.get_cached(d) is None
    assert pipe._bufpool.leased == 0


def test_digest_prefixes_follow_window_order(hasher):
    """The in-order digest prefixes a resumable upload reads: empty before
    any window, then the first N digests of the finished stream."""
    pipe = IngestPipeline(
        hasher, IngestConfig(window_bytes=WINDOW, windows_in_flight=2, pack_mode="device")
    )
    blob = _blob(2 * WINDOW + 3 * PLEN + 7, 13)
    empty = pipe.session(PLEN)
    assert empty.completed_digest_prefix().shape == (0, 32)
    assert empty.digest_prefix(5).shape == (0, 32)
    ses, got = _stream(pipe, blob)
    assert np.array_equal(got, kt.CPUPieceHasher().hash_pieces(blob, PLEN))
    assert np.array_equal(ses.completed_digest_prefix(), got)
    assert np.array_equal(ses.digest_prefix(1500), got[:1500])
    assert np.array_equal(ses.digest_prefix(10**6), got)


def test_failpoint_triggers_replay_as_kraken_tpu_does():
    """The trigger grammar, and the seeded firing sequences, equal
    kraken_tpu's registry spec for spec; malformed specs fail in both."""
    from kraken_tpu.utils import failpoints as jax_failpoints

    port, ref = failpoints.FailpointRegistry(), jax_failpoints.FailpointRegistry()
    assert port.fire("nothing.armed") is None
    for spec in ("once", "every:3", "prob:0.5+seed:7", "always+times:2", "prob:0.3"):
        port.arm("s", spec)
        ref.arm("s", spec)
        seq = [bool(port.fire("s")) for _ in range(32)]
        assert seq == [bool(ref.fire("s")) for _ in range(32)], spec
        assert any(seq)
    port.arm("d", "always+delay:250")
    assert abs(port.fire("d").delay_s - 0.25) < 1e-9
    for bad in ("sometimes", "prob:1.5", "every:0", "once+nope:1", "every"):
        with pytest.raises(ValueError):
            port.arm("f", bad)
        with pytest.raises(ValueError):
            ref.arm("f", bad)
    assert port.disarm("d") and port.fire("d") is None
    assert port.snapshot()["failpoints"]["s"]["spec"] == "prob:0.3"


def test_failpoints_env_names_and_boot_guard():
    """The env surface arms only declared ingest sites and acknowledges
    itself; armed sites without the acknowledgement fail assert_safe."""
    try:
        n = failpoints.load_from_env(
            {"KRAKEN_FAILPOINTS": "ingest.window.pack=once, origin.ingest.device_fail = every:2"}
        )
        assert n == 2 and failpoints.FAILPOINTS.allowed and failpoints.any_armed()
        snap = failpoints.FAILPOINTS.snapshot()["failpoints"]
        assert snap["origin.ingest.device_fail"]["spec"] == "every:2"
        failpoints.FAILPOINTS.assert_safe("test")
        with pytest.raises(ValueError, match="KNOWN_FAILPOINTS"):
            failpoints.load_from_env({"KRAKEN_FAILPOINTS": "ingest.windw.read=once"})
        with pytest.raises(ValueError):
            failpoints.load_from_env({"KRAKEN_FAILPOINTS": "justaname"})
        failpoints.allow(False)
        with pytest.raises(failpoints.FailpointConfigError):
            failpoints.FAILPOINTS.assert_safe("test")
    finally:
        failpoints.FAILPOINTS.disarm_all()
        failpoints.allow(False)
    assert not failpoints.any_armed()
    failpoints.FAILPOINTS.assert_safe("test")


def test_bufpool_size_classes_reuse_and_budget():
    """Leases draw power-of-two classes, are reused, release once, and the
    retained bytes stay under a live-resizable budget."""
    from kraken_tpu_torch.utils.bufpool import MIN_CLASS, BufferPool, _class_for

    pool = BufferPool(budget_bytes=2 * MIN_CLASS)
    assert _class_for(1) == MIN_CLASS and _class_for(MIN_CLASS + 1) == 2 * MIN_CLASS
    a = pool.lease(100)
    assert len(a.view) == 100 and pool.leased == 1 and pool.misses == 1
    a.release()
    assert pool.leased == 0 and pool.retained_bytes == MIN_CLASS
    b = pool.lease(200)  # same class: reused
    assert pool.hits == 1 and pool.allocated == 1 and pool.hit_ratio() == 0.5
    b.release()
    b.release()  # idempotent: no double return
    assert pool.retained_bytes == MIN_CLASS
    leases = [pool.lease(10) for _ in range(3)]
    for lease in leases:
        lease.release()
    assert pool.retained_bytes <= 2 * MIN_CLASS
    pool.set_budget(0)
    pool.lease(10).release()
    pool.lease(10).release()
    assert pool.retained_bytes == 0
    view = (lease := pool.lease(50)).view
    view[0] = 7
    lease.release()
    with pytest.raises(ValueError):
        view[0]  # a released view is loud, never recycled bytes
    assert 'bufpool_leased{pool="wire"}' in REGISTRY.render()


def test_apply_resizes_pool_and_executor(hasher):
    """A live config swap resizes the staging budget and, when the window
    count changed, retires the executor; an equal config is a no-op."""
    cfg = IngestConfig(window_bytes=WINDOW, windows_in_flight=2)
    pipe = IngestPipeline(hasher, cfg)
    assert pipe._bufpool.budget_bytes == 3 * WINDOW
    ex = pipe._get_executor()
    pipe.apply(cfg)
    assert pipe._get_executor() is ex
    pipe.apply(IngestConfig(window_bytes=2 * WINDOW, windows_in_flight=2))
    assert pipe._bufpool.budget_bytes == 6 * WINDOW
    assert pipe._get_executor() is ex  # same width: kept
    pipe.apply(IngestConfig(window_bytes=2 * WINDOW, windows_in_flight=4))
    assert pipe._bufpool.budget_bytes == 10 * WINDOW
    ex4 = pipe._get_executor()
    assert ex4 is not ex and pipe._executor_width == 4
    ses = pipe.session(PLEN)
    assert ses.window_bytes == 2 * WINDOW and ses._sem._value == 4
    # In-flight sessions keep their birth config; new ones see the swap.
    pipe.apply(IngestConfig(window_bytes=WINDOW, windows_in_flight=4, pack_mode="device"))
    assert ses._cfg.pack_mode == "host"
    assert pipe.session(PLEN)._cfg.pack_mode == "device"
    ex.shutdown(wait=True)
    ex4.shutdown(wait=True)
