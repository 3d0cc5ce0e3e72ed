"""Percentiles, the union-based idle share and the trace reductions on
synthetic records and traces."""

import pytest

from benchmark import stats, trace
from benchmark.harness import breakdown, short_name


def test_p95_and_mean():
    v = list(range(1, 101))                  # 1..100
    assert stats.p95(v) == 95
    assert stats.p95([3.0]) == 3.0
    assert stats.p95(list(range(1, 21))) == 19
    assert stats.p95([]) is None
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert stats.union_length(iv) == 25
    assert stats.union_length(iv, 8, 22) == 9      # 8-15 and 20-22
    assert stats.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert stats.merge(iv) == [(0, 15), (20, 30)]
    assert stats.intersect([(0, 15), (20, 30)], [(10, 22), (29, 40)]) == \
        [(10, 15), (20, 22), (29, 30)]


def _trace():
    # span 0-100 us, 4 frames; two overlapping kernels, a copy, a memset
    dev = [("kernel", "void (anonymous namespace)::k1_reduce<unsigned int>"
            "(unsigned int const*)", 0.0, 30.0),
           ("kernel", "void k3_loop_kernel<16>(float*)", 20.0, 50.0),
           ("memcpy_dtoh", "Memcpy DtoH (Device -> Pinned)", 60.0, 70.0),
           ("memset", "Memset (Device)", 65.0, 75.0),
           ("kernel", "void k1_init(int*)", 90.0, 130.0)]
    host = [("aten::copy_", 50.0, 60.0), ("cudaStreamSynchronize", 74.0,
                                          95.0)]
    # two calls; the first's work runs on to 50 us, then the loop waits
    calls = [(0.0, 45.0), (60.0, 72.0)]
    return {"device": dev, "host": host, "calls": calls,
            "span": (0.0, 100.0), "frames": 4}


def test_trace_reductions():
    run = {"trace": _trace()}
    # frame windows 0-50 and 60-100 (the second's last kernel runs past
    # the span); busy in them: 0-50, 60-75, 90-100 = 75 of 90 us (the
    # summed durations would give 125); the wait 50-60 is in neither
    assert trace.frame_windows(run["trace"]) == [(0.0, 50.0), (60.0, 100.0)]
    assert trace.idle_share(run) == pytest.approx(1 - 75 / 90)
    assert trace.busy_s(run["trace"]) == pytest.approx((75e-6, 100e-6))
    assert trace.device_ms(run, r"\bk1_") == pytest.approx(
        (30 + 10) / 1000 / 4)
    assert trace.device_ms(run, r"\bk3_loop_kernel") == pytest.approx(
        30 / 1000 / 4)
    assert trace.device_ms(run, r"\bk2_") is None
    assert trace.count_per_frame(run, ("kernel",)) == 3 / 4
    assert trace.count_per_frame(run, ("memcpy_dtoh",)) == 1 / 4
    assert trace.idle_share({"trace": None}) is None


def test_breakdown_names_gaps_by_host_range():
    b = breakdown(_trace())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "k1_reduce<unsigned int>"
    assert "k3_loop_kernel<16>" in names
    gaps = dict(b["idle_gaps"])
    assert "aten::copy_" not in gaps            # 50-60: between frames
    assert gaps["cudaStreamSynchronize"] == pytest.approx(15e-6)  # 75-90
    assert short_name("void f<a(b)>(int)") == "f<a(b)>"
