"""The port's relayout diagnostic on the CPU: the plain version of
``csrc/transpose.cu`` (the CPU route of both its wrappers,
``transpose_only`` and ``natural_loads_only``), held bit for bit against
``bench_transpose.py``'s ``transpose_only`` run as a Pallas kernel in
interpret mode, and the port's natural-vs-packed gap decomposition
(``kraken_tpu_torch.bench.transpose``).

``transpose_only`` is a closure inside ``bench_transpose.py``'s ``main()``,
so its two nested ``def``s are lifted out with ``ast`` and run in a
namespace that gives them the names ``main()`` would: the piece length's
block counts, the tile constants of ``kraken_tpu.ops.sha256_pallas``, and a
``pl`` whose ``pallas_call`` runs in interpret mode.
"""

import ast
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kraken_tpu.ops import sha256_pallas
from kraken_tpu_torch.bench import transpose as bench
from kraken_tpu_torch.bench.transpose import decompose
from kraken_tpu_torch.ops import sha256_cuda, transpose_cuda
from kraken_tpu_torch.ops.transpose_cuda import natural_loads_only, transpose_only
from kraken_tpu_torch.ops.transpose_ref import transpose_only_ref

BENCH = Path(__file__).resolve().parent.parent / "bench_transpose.py"
WRAPPERS = {"transpose_only": transpose_only, "natural_loads_only": natural_loads_only}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # One intra-op thread keeps this module from competing for every core
    # with the timing-band tests that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _InterpretPallas:
    """``pl`` with every ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@functools.lru_cache(maxsize=None)
def jax_transpose_only(piece_len: int):
    """``bench_transpose.py``'s ``transpose_only`` for pieces of
    ``piece_len`` bytes: [1024, piece_len] uint8 -> [1, 8, 8, 128] uint32."""
    tree = ast.parse(BENCH.read_text(), filename=str(BENCH))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [
        n for n in main.body
        if isinstance(n, ast.FunctionDef) and n.name in ("transpose_only_kernel", "transpose_only")
    ]
    assert [d.name for d in defs] == ["transpose_only_kernel", "transpose_only"]
    nb = piece_len // 64
    ns = {
        "nb": nb, "ngroups": nb // sha256_pallas._KB,
        "_KB": sha256_pallas._KB, "_LANES": sha256_pallas._LANES,
        "_SUB": sha256_pallas._SUB, "N_TILE": sha256_pallas.N_TILE,
        "jax": jax, "jnp": jnp, "np": np, "functools": functools,
        "pl": _InterpretPallas(), "pltpu": pltpu,
    }
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(BENCH), "exec"), ns)
    return ns["transpose_only"]


def _jax(rows: np.ndarray) -> np.ndarray:
    """The JAX kernel over each 1024-row tile, concatenated."""
    fn = jax_transpose_only(rows.shape[1])
    return np.concatenate([
        np.asarray(fn(jnp.asarray(rows[t : t + 1024]))) for t in range(0, rows.shape[0], 1024)
    ])


def _port(rows: np.ndarray, wrapper=transpose_only) -> np.ndarray:
    return wrapper(torch.from_numpy(rows)).numpy().view(np.uint32)


def _rows(m: int, p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (m, p), dtype=np.uint8)


def _distinct(m: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Rows that are zero but for the first line of piece q, whose
    big-endian word i is q * 8 + i, and the fold they must give: word i of
    piece t * 1024 + s * 128 + l at [t, i, s, l]."""
    first = (np.arange(m, dtype=np.uint32)[:, None] << 3) | np.arange(8, dtype=np.uint32)
    rows = np.zeros((m, p), dtype=np.uint8)
    rows[:, :32] = first.astype(">u4").view(np.uint8)
    return rows, first.reshape(m // 1024, 8, 128, 8).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("p", [512, 1024])
def test_plain_version_equals_the_jax_kernel(p):
    rows = _rows(1024, p, seed=p)
    want = _jax(rows)
    assert want.shape == (1, 8, 8, 128) and want.dtype == np.uint32
    assert np.array_equal(_port(rows), want)


def test_piece_distinct_layout_equals_the_jax_kernel_and_the_closed_form():
    rows, want = _distinct(1024, 512)
    assert np.array_equal(_jax(rows), want)
    assert np.array_equal(_port(rows), want)


def test_two_tiles_equal_two_jax_calls():
    rows = _rows(2048, 512, seed=7)
    got = _port(rows)
    assert got.shape == (2, 8, 8, 128)
    assert np.array_equal(got, _jax(rows))
    rows, want = _distinct(2048, 512)
    assert np.array_equal(_port(rows), want)


def _fold(rows: np.ndarray) -> np.ndarray:
    """The XOR of each piece's big-endian words by index mod 8, laid out
    [t, i, s, l]: the function, in numpy."""
    m = rows.shape[0]
    fold = np.bitwise_xor.reduce(rows.view(">u4").reshape(m, -1, 8), axis=1).astype(np.uint32)
    return fold.reshape(m // 1024, 8, 128, 8).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("p", [512, 1536, 4096])
def test_plain_version_is_the_xor_fold_of_big_endian_words(p):
    # 1536 B is 48 lines: the halving fold meets an odd line count.
    rows = _rows(3072, p, seed=p + 1)
    assert np.array_equal(_port(rows), _fold(rows))


@pytest.mark.parametrize("p", [512, 1024])
def test_natural_loads_only_equals_the_plain_version_and_the_jax_kernel(p):
    transpose_cuda.reset_launches()
    rows = _rows(1024, p, seed=p)
    got = _port(rows, natural_loads_only)
    assert np.array_equal(got, transpose_only_ref(torch.from_numpy(rows)).numpy().view(np.uint32))
    assert np.array_equal(got, _jax(rows))
    assert transpose_cuda.LAUNCHES == {"transpose_only": 0, "natural_loads_only": 0}


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_piece_of_a_partial_segment_folds_whole(name):
    # 16 KiB + 4,608 B: not a whole number of the card fold's 16 KiB
    # segments (its edge segment on the card); on the CPU the plain version.
    rows = _rows(1024, 16 * 1024 + 4608, seed=11)
    assert np.array_equal(_port(rows, WRAPPERS[name]), _fold(rows))


def test_jax_kernel_drops_a_partial_group_the_port_refuses_it():
    # The JAX grid has nb // 8 steps: at 768 B it folds only the first
    # 512 bytes of each piece. The port raises instead.
    rows = _rows(1024, 768, seed=3)
    assert np.array_equal(_jax(rows), _port(np.ascontiguousarray(rows[:, :512])))
    with pytest.raises(ValueError, match="multiple of 512"):
        _port(rows)


_BAD = {
    "p768": lambda: torch.zeros((1024, 768), dtype=torch.uint8),  # P not a multiple of 512
    "m1000": lambda: torch.zeros((1000, 512), dtype=torch.uint8),  # rows not a multiple of 1024
    "m0": lambda: torch.zeros((0, 512), dtype=torch.uint8),  # no rows
    "p0": lambda: torch.zeros((1024, 0), dtype=torch.uint8),  # no bytes
    "int8": lambda: torch.zeros((1024, 512), dtype=torch.int8),  # wrong dtype
    "int32": lambda: torch.zeros((1024, 512), dtype=torch.int32),  # wrong dtype
    "strided": lambda: torch.zeros((1024, 1024), dtype=torch.uint8)[:, ::2],  # not contiguous
    "1d": lambda: torch.zeros((1024 * 512,), dtype=torch.uint8),  # not 2-D
}


# transpose_only's cases keep their bare ids; natural_loads_only's are
# prefixed with its name.
@pytest.mark.parametrize("wrapper,bad", [
    pytest.param(name, bad, id=bad if name == "transpose_only" else f"{name}-{bad}")
    for name in WRAPPERS for bad in _BAD
])
def test_wrapper_refuses_what_the_kernel_does_not_take(wrapper, bad):
    with pytest.raises(ValueError):
        WRAPPERS[wrapper](_BAD[bad]())


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    transpose_cuda.reset_launches()
    rows = torch.from_numpy(_rows(1024, 512, seed=5))
    for wrapper in WRAPPERS.values():
        assert torch.equal(wrapper(rows), transpose_only_ref(rows))
    assert transpose_cuda.LAUNCHES == {"transpose_only": 0, "natural_loads_only": 0}


_KEYS = {
    "metric", "value", "unit", "transpose_only_gbps", "natural_loads_gbps",
    "rounds_only_packed_gbps", "natural_gbps", "predicted_natural_gbps",
    "transpose_only_ms", "natural_loads_ms", "rounds_only_packed_ms", "natural_ms",
    "transpose_only_plain_ms", "tiles", "pieces", "piece_len", "device",
}


@pytest.fixture
def one_rep(monkeypatch):
    monkeypatch.setattr(bench, "REPS", 1)


@pytest.mark.parametrize("tiles", [1, 2])
def test_decompose_on_the_cpu_returns_every_key_and_its_check_passes(tiles, one_rep):
    # It raises if the natural and packed digests differ or the
    # transpose-only words differ from the plain version's.
    r = decompose(tiles, 512, device="cpu")
    assert set(r) == _KEYS
    assert r["metric"] == "natural_gap_decomposition" and r["device"] == "cpu"
    assert (r["tiles"], r["pieces"], r["piece_len"]) == (tiles, tiles * 1024, 512)
    rates = [r[k] for k in _KEYS if k.endswith(("_gbps", "_ms"))] + [r["value"]]
    assert all(math.isfinite(x) and x > 0 for x in rates)
    # The serial prediction is from the natural kernel's own loads.
    predicted = 1 / (1 / r["natural_loads_gbps"] + 1 / r["rounds_only_packed_gbps"])
    assert r["predicted_natural_gbps"] == pytest.approx(predicted, rel=1e-12)
    assert r["value"] == pytest.approx(r["natural_gbps"] / predicted, rel=1e-12)
    for leg in ("natural", "natural_loads", "transpose_only"):
        assert r[f"{leg}_gbps"] == pytest.approx(
            tiles * 1024 * 512 / r[f"{leg}_ms"] / 1e6, rel=1e-12)


def test_decompose_on_the_cpu_launches_no_kernel(one_rep):
    transpose_cuda.reset_launches()
    sha256_cuda.reset_launches()
    decompose(1, 512, device="cpu")
    assert set(transpose_cuda.LAUNCHES.values()) == {0}
    assert set(sha256_cuda.LAUNCHES.values()) == {0}


def test_decompose_value_moves_with_the_natural_loads_leg_not_transpose_only(one_rep, monkeypatch):
    # Leg times stubbed in call order (one timed launch a leg: transpose_only,
    # natural_loads, natural, rounds_only_packed; then the plain version):
    # the prediction reads the loads leg, and the transpose-only time
    # changes nothing.
    def run(t_ms):
        times = iter([t_ms, 2.0, 4.0, 3.0, 1.0])
        monkeypatch.setattr(bench, "_ms", lambda fn, dev: (fn(), next(times))[1])
        return decompose(1, 512, device="cpu")

    fast, slow = run(0.5), run(50.0)
    for r in (fast, slow):
        assert r["natural_loads_ms"] == 2.0 and r["rounds_only_packed_ms"] == 3.0
        assert r["value"] == pytest.approx((2.0 + 3.0) / 4.0, rel=1e-12)
    assert fast["value"] == slow["value"]
    assert (fast["transpose_only_ms"], slow["transpose_only_ms"]) == (0.5, 50.0)


@pytest.mark.parametrize("kw", [
    {"tiles": 0, "piece_len": 512}, {"tiles": 1, "piece_len": 768},
    {"tiles": 1, "piece_len": 0},
], ids=["tiles0", "p768", "p0"])
def test_decompose_refuses_bad_arguments(kw):
    with pytest.raises(ValueError):
        decompose(device="cpu", **kw)
