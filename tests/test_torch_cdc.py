"""The port's FastCDC on the CPU: the plain gear pass (the CPU route of
``csrc/gear.cu``'s wrapper), the windowed candidate scan and the chunker,
held exactly against ``kraken_tpu``'s XLA pass, its Pallas gear kernel in
interpret mode, its chunkers and the sequential reference. Chunk
boundaries are an on-disk contract: no tolerance anywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.ops import cdc as jax_cdc
from kraken_tpu.ops.cdc_pallas import _SEG, candidate_indices_pallas
from kraken_tpu_torch import native
from kraken_tpu_torch.ops import cdc, cdc_cuda
from kraken_tpu_torch.ops.cdc import CDCParams, chunk, chunk_host, chunk_reference
from kraken_tpu_torch.ops.cdc_ref import gear_candidates_ref, gear_hashes_ref

P = CDCParams(min_size=64, avg_size=256, max_size=1024)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # One intra-op thread keeps this module from competing for every core
    # with the timing-band tests that run beside it under pytest-xdist.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def test_gear_table_and_masks_are_the_jax_packages():
    assert np.array_equal(cdc.GEAR, jax_cdc.GEAR)
    for p in (P, CDCParams()):
        jp = jax_cdc.CDCParams(p.min_size, p.avg_size, p.max_size, p.norm)
        assert (p.bits, p.mask_strict, p.mask_loose) == (
            jp.bits, jp.mask_strict, jp.mask_loose
        )


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 65539])
@pytest.mark.parametrize("params", [P, CDCParams()], ids=["small", "default"])
def test_plain_gear_pass_matches_xla(n, params):
    data = rand(n, seed=n)
    strict, loose = gear_candidates_ref(
        torch.from_numpy(data), params.mask_strict, params.mask_loose
    )
    want_s, want_l = jax_cdc._gear_candidates(
        jnp.asarray(data), params.mask_strict, params.mask_loose
    )
    assert np.array_equal(strict.numpy(), np.asarray(want_s))
    assert np.array_equal(loose.numpy(), np.asarray(want_l))


def test_plain_hash_is_the_sequential_rolling_hash():
    data = rand(300, seed=3)
    h, want = 0, []
    for b in data:
        h = ((h << 1) + int(cdc.GEAR[b])) & 0xFFFFFFFF
        want.append(h)
    assert gear_hashes_ref(torch.from_numpy(data)).tolist() == want


@pytest.fixture(scope="module")
def planted():
    """2 segments of the Pallas kernel + a ragged tail, whose first 31 bytes
    hash (with zero history) onto the loose mask: the window where a lead
    taken as zero BYTES instead of zero gear values would diverge. Returns
    the bytes and the Pallas kernel's candidates (interpret mode)."""
    p = CDCParams()
    n = 2 * _SEG + 12_345
    arr = rand(n, seed=11)
    for seed in range(10_000):
        prefix = rand(cdc._WINDOW - 1, seed=seed)
        _s, early_loose = gear_candidates_ref(
            torch.from_numpy(prefix), p.mask_strict, p.mask_loose
        )
        if bool(early_loose.any()):
            arr[: cdc._WINDOW - 1] = prefix
            break
    else:
        raise AssertionError("no early-candidate prefix found")
    want = candidate_indices_pallas(
        arr, n, p.mask_strict, p.mask_loose, interpret=True
    )
    assert want[1].size and want[1][0] < cdc._WINDOW - 1
    return arr, want


@pytest.mark.parametrize("window", [None, _SEG, 100_003])
def test_windowed_candidates_match_pallas_interpret(planted, window, monkeypatch):
    arr, (want_s, want_l) = planted
    if window is not None:
        monkeypatch.setattr(cdc_cuda, "WINDOW_BYTES", window)
    s_idx, l_idx = cdc_cuda.candidate_indices(arr, arr.size, CDCParams(), CPU)
    np.testing.assert_array_equal(s_idx, want_s)
    np.testing.assert_array_equal(l_idx, want_l)


@pytest.mark.parametrize(
    "n", [0, 1, cdc._WINDOW, P.min_size, P.min_size + 1, 37 * cdc._WINDOW + 5,
          1000, 4096, 65536 + 7]
)
def test_chunk_matches_jax_and_reference(n):
    data = rand(n, seed=n).tobytes()
    got = chunk(data, P, device="cpu")
    assert got == jax_cdc.chunk(data, P)
    assert got == chunk_reference(data, P)


def test_chunk_structured_data_matches_reference():
    # Long runs exercise the forced max_size cut and a constant hash.
    data = (b"\x00" * 3000) + rand(3000, 1).tobytes() + (b"ab" * 2000)
    assert chunk(data, P, device="cpu") == chunk_reference(data, P)


def test_chunk_default_params_one_mib():
    data = rand(1 << 20, seed=5).tobytes()
    got = chunk(data, device="cpu")
    assert len(got) > 4
    assert got == jax_cdc.chunk(data)
    assert got == chunk_host(data).tolist()


@pytest.mark.parametrize("window", [16, 4096, 10_007])
def test_windows_match_the_whole_blob(window, monkeypatch):
    data = rand(60_000, seed=7).tobytes()
    whole = chunk(data, P, device="cpu")
    monkeypatch.setattr(cdc_cuda, "WINDOW_BYTES", window)
    assert chunk(data, P, device="cpu") == whole
    assert whole == chunk_reference(data, P)


@pytest.mark.parametrize("n", [0, 5, 100_000])
@pytest.mark.parametrize("params", [P, CDCParams()], ids=["small", "default"])
def test_chunk_host_matches_jax(n, params):
    data = rand(n, seed=n + 1).tobytes()
    jp = jax_cdc.CDCParams(params.min_size, params.avg_size, params.max_size)
    got = chunk_host(data, params)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jax_cdc.chunk_host(data, jp))


def test_chunk_host_without_a_compiler_runs_the_plain_pass(monkeypatch):
    data = rand(50_000, seed=9).tobytes()
    want = chunk_host(data, P)
    monkeypatch.setattr(native, "cdc_chunk_native", lambda *a: None)
    got = chunk_host(data, P)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "args",
    [(16 * 1024, 64 * 1024, 256 * 1024, 2), (64, 256, 1024, 2), (32, 32, 32, 0),
     (64, 256, 1024, 9), (64, 100, 1024, 2), (512, 256, 1024, 2),
     (64, 256, 128, 2), (16, 32, 64, 2)],
)
def test_params_validation_parity(args):
    try:
        jp = jax_cdc.CDCParams(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            CDCParams(*args)
        return
    p = CDCParams(*args)
    assert (p.bits, p.mask_strict, p.mask_loose) == (
        jp.bits, jp.mask_strict, jp.mask_loose
    )


def test_window_candidates_layout_and_checks():
    """The wrapper's one-window contract on the CPU route: history bytes
    before the window count, earlier bytes do not, no position >= n is
    returned, positions come sorted; bad buffers are refused; the CPU
    route launches nothing."""
    p = CDCParams(64, 256, 1024)
    data = rand(5000, seed=4)
    n, hist = 3000, 17
    buf = torch.zeros(cdc_cuda.LEAD + cdc_cuda.padded(n), dtype=torch.uint8)
    buf[: cdc_cuda.LEAD] = 0xAB  # beyond the history: must not count
    buf[cdc_cuda.LEAD - hist : cdc_cuda.LEAD + n] = torch.from_numpy(data[: hist + n])
    buf[cdc_cuda.LEAD + n :] = torch.from_numpy(data[hist + n : hist + cdc_cuda.padded(n)])
    cdc_cuda.reset_launches()
    got_s, got_l = cdc_cuda.gear_candidates(buf, n, hist, p.mask_strict, p.mask_loose)
    s, l = gear_candidates_ref(torch.from_numpy(data[: hist + n]), p.mask_strict, p.mask_loose)
    np.testing.assert_array_equal(got_s, np.flatnonzero(s.numpy()[hist:]))
    np.testing.assert_array_equal(got_l, np.flatnonzero(l.numpy()[hist:]))
    assert got_l.size > got_s.size > 0 and got_l.dtype == np.int64
    assert got_l.max() < n and np.all(np.diff(got_l) > 0) and np.all(np.diff(got_s) > 0)
    # Every position at mask 0: none past n although the padding is data.
    all_s, all_l = cdc_cuda.gear_candidates(buf, n, hist, 0, 0)
    np.testing.assert_array_equal(all_s, np.arange(n))
    np.testing.assert_array_equal(all_l, np.arange(n))
    with pytest.raises(ValueError, match="needs"):
        cdc_cuda.gear_candidates(buf[:-1], n, hist, p.mask_strict, p.mask_loose)
    with pytest.raises(ValueError, match="hist"):
        cdc_cuda.gear_candidates(buf, n, 32, p.mask_strict, p.mask_loose)
    with pytest.raises(ValueError, match="uint8"):
        cdc_cuda.gear_candidates(buf.long(), n, hist, p.mask_strict, p.mask_loose)
    with pytest.raises(ValueError, match="cuda"):
        cdc_cuda.launch(buf, n, hist, p.mask_strict, p.mask_loose,
                        torch.empty(n + 1, dtype=torch.int32))
    assert cdc_cuda.LAUNCHES["gear_candidates"] == 0  # the CPU route launches nothing


@pytest.mark.parametrize("route", ["dense, candidate_indices", "mask 0, one window"])
def test_port_candidates_match_pallas_interpret(route):
    """The port's candidates on the CPU against the Pallas kernel in
    interpret mode: at CDCParams(64, 256, 1024) (loose candidates ~1 in 64)
    through the window loop, and at mask 0 (every position; no CDCParams
    gives it) through the one-window wrapper, on a window with history."""
    arr = rand(70_000, seed=21)
    if route.startswith("dense"):
        p = CDCParams(64, 256, 1024)
        want = candidate_indices_pallas(arr, arr.size, p.mask_strict, p.mask_loose,
                                        interpret=True)
        got = cdc_cuda.candidate_indices(arr, arr.size, p, CPU)
        assert want[1].size > 500
    else:
        s, m, hist = 40_000, 20_000, 31
        full = candidate_indices_pallas(arr, s + m, 0, 0, interpret=True)
        want = [w[w >= s] - s for w in full]
        buf = torch.zeros(cdc_cuda.LEAD + cdc_cuda.padded(m), dtype=torch.uint8)
        buf[cdc_cuda.LEAD - hist : cdc_cuda.LEAD + m] = torch.from_numpy(arr[s - hist : s + m])
        got = cdc_cuda.gear_candidates(buf, m, hist, 0, 0)
        assert want[0].size == m
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize(
    "mask_s, mask_l, why",
    [(0xFFFF0001, 0xFFF00000, "mask_s"),  # strict not a top-bit mask
     (0xFFFC0000, 0x0FF00000, "mask_l"),  # loose not a top-bit mask
     (0xFFF00000, 0xFFFC0000, "contain"),  # loose wider than strict
     (1 << 32, 0, "mask_s"), (0, -1, "mask_l")],
)
def test_masks_must_be_nested_top_bit_masks(mask_s, mask_l, why):
    """The kernel tests both masks with one compare, so the port takes
    only what CDCParams makes; the Pallas kernel takes any integers."""
    buf = torch.zeros(cdc_cuda.LEAD + cdc_cuda.STEP, dtype=torch.uint8)
    with pytest.raises(ValueError, match=why):
        cdc_cuda.gear_candidates(buf, 100, 0, mask_s, mask_l)
    with pytest.raises(ValueError, match=why):
        cdc.check_masks(mask_s, mask_l)
    for p in (P, CDCParams(), CDCParams(32, 32, 32, 0), CDCParams(64, 256, 1024, 9)):
        cdc.check_masks(p.mask_strict, p.mask_loose)


def test_codes_split_into_sorted_strict_and_loose():
    """The host helper both routes share: codes pos << 2 | kind (bit 0
    strict, bit 1 loose) in any order -> the sorted position lists."""
    rng = np.random.default_rng(3)
    pos = rng.choice(1 << 26, 5000, replace=False)
    kind = rng.choice([2, 3], pos.size)  # nested masks: a strict hit is a loose hit
    codes = (pos << 2 | kind).astype(np.int32)
    rng.shuffle(codes)
    strict, loose = cdc.split_codes(codes)
    np.testing.assert_array_equal(strict, np.sort(pos[kind == 3]))
    np.testing.assert_array_equal(loose, np.sort(pos))
    assert strict.dtype == loose.dtype == np.int64
    empty = cdc.split_codes(np.empty(0, dtype=np.int32))
    assert empty[0].size == empty[1].size == 0
