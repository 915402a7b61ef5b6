"""The yardstick's arithmetic against hand figures: the roofline, the
arrivals, the trace's reduction and the readers."""

import math

import numpy as np
import pytest

from portbench import devtrace, readers, roofline, traffic


def test_roofline_matches_the_hand_figures():
    # 4 MiB: 65,537 compressions x 1,040 ALU operations / 16.73 T/s.
    assert roofline.least_seconds_rows([4 << 20]) == pytest.approx(4.07e-6, rel=2e-3)
    assert roofline.least_seconds_rows([4 << 20] * 256) == pytest.approx(1.043e-3, rel=2e-3)
    assert roofline.ALU_OPS_PER_BLOCK == 1040 and roofline.EITHER_OPS_PER_BLOCK == 360
    assert roofline.blocks(55) == 1 and roofline.blocks(56) == 2


def test_blocks_from_totals_never_count_high():
    lengths = [4 << 20, 175_375, 3_418_017, 1]
    exact = sum(roofline.blocks(n) for n in lengths)
    low = roofline.blocks_lower(sum(lengths), len(lengths))
    assert exact - len(lengths) < low <= exact


def test_arrivals_give_every_seed_the_same_bursts_in_another_phase():
    a = traffic.arrivals(2**31 + 5, 1.2, 40, 1)
    b = traffic.arrivals(7, 1.2, 40, 1)
    assert len(a) == len(b) == 48
    assert a[0] == b[0] == 0.0 and max(a) < 40 and max(b) < 40
    gaps = lambda d: np.diff(d + [40.0]).round(9).tolist()
    assert sorted(gaps(a)) == sorted(gaps(b))
    assert a != b
    # One cycle of gaps, rotated: b's sequence is a's, begun elsewhere.
    ga, gb = gaps(a), gaps(b)
    assert any(ga[k:] + ga[:k] == gb for k in range(len(ga)))
    assert traffic.arrivals(2**31 + 5, 1.2, 40, 1) == a
    assert traffic.arrivals(7, 1.2, 40, 2) != b
    # The gaps are an exponential distribution's, stratified: mean 1 / rate.
    assert np.mean(ga) == pytest.approx(40 / 48)
    assert np.median(ga) == pytest.approx(math.log(2) * 40 / 48, rel=0.1)


def test_seeded_bytes_repeat_and_differ_by_key():
    assert traffic.blob(2**33, (2, 0, 1), 1000) == traffic.blob(2**33, (2, 0, 1), 1000)
    assert traffic.blob(2**33, (2, 0, 1), 1000) != traffic.blob(2**33, (2, 1, 1), 1000)


def test_trace_reduction_reads_only_the_window():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW_MARK, "ts": 100, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "sha256_rows_kernel", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "sha256_rows_kernel", "ts": 300, "dur": 200},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 450, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 560, "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 2000, "dur": 10},
    ]
    t = devtrace.reduce(ev)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx((50 + 250) / 1e6)
    assert t["ops"]["sha256_rows_kernel"] == pytest.approx(250e-6)
    assert "other" not in t["ops"]
    assert t["breakdown"]["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(550e-6)]
    assert devtrace.kernel_seconds(t, "sha256_rows") == pytest.approx(250e-6)


def test_a_failed_pull_counts_as_beyond_any_time():
    obs = {"window_s": 10, "grace_s": 60, "pulls": [
        {"due": 0, "end": 1.0, "status": 200, "bytes": 5},
        {"due": 1, "end": None, "status": None, "bytes": 0}]}
    assert readers.pull_latencies(obs) == [1.0, 70]
    assert readers.pull_quantile(obs, 0.9) == 70
    assert readers.rank([3, 1, 2, 4], 0.5) == 2


def test_a_roofline_share_is_none_without_kernel_time():
    obs = {"trace": None, "counters": {"window": {"rows_hashed": 4, "bytes_hashed": 4 << 22}}}
    assert readers.roofline_pct(obs) is None
    assert readers.idle_pct(obs) is None


def test_no_module_of_the_benchmark_touches_the_card_at_import():
    import importlib
    import pkgutil

    import portbench

    for mod in pkgutil.walk_packages(portbench.__path__, "portbench."):
        if ".tests" not in mod.name:
            importlib.import_module(mod.name)
    import torch

    assert not torch.cuda.is_initialized()
    assert math.isclose(roofline.ALU_OPS_PER_S, 132 * 64 * 1.98e9)
