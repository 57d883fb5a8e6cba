"""The metric arithmetic on synthetic timings and traces."""

import numpy as np
import pytest

from harness import cell, shares, trace


def ctx_of(**window):
    w = {"iter_ms": [], "read_wait_ms": [], "densify_ms": [], "latency_ms": [], "host_ms": []}
    w.update(window)
    return dict(kind="train", cfg={}, window=w, setup_s=3.0, peak_bytes=3 << 30)


def test_rate_is_over_the_whole_window():
    # 3 iterations in a 2 s window, however the iterations' own times read
    c = ctx_of(iter_ms=[1.0, 1.0, 1.0], seconds=2.0)
    assert cell.reader("train_step_ms")(c) == pytest.approx(2000.0 / 3)
    c = ctx_of(latency_ms=[5.0] * 7, seconds=2.0)
    assert cell.reader("frames_per_s")(c) == pytest.approx(3.5)


def test_tail_is_over_all_requests():
    lat = list(range(1, 201))          # 200 requests, 1..200 ms
    c = ctx_of(latency_ms=lat, seconds=1.0)
    assert cell.reader("frame_ms_p95")(c) == pytest.approx(np.percentile(lat, 95))
    assert cell.reader("frame_ms_p95")(c) == pytest.approx(190.05)


def test_host_and_densify_ms():
    c = ctx_of(iter_ms=[10.0, 20.0], read_wait_ms=[4.0, 6.0], densify_ms=[30.0, 50.0],
               seconds=1.0)
    assert cell.reader("host_ms.train")(c) == pytest.approx(10.0)
    assert cell.reader("densify_ms.train")(c) == pytest.approx(40.0)
    c = ctx_of(latency_ms=[9.0, 9.0], host_ms=[1.0, 3.0], seconds=1.0)
    assert cell.reader("host_ms.render")(c) == pytest.approx(2.0)
    assert cell.reader("peak_mem_gib")(c) == pytest.approx(3.0)


def test_idle_share_from_the_union_of_intervals():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    c = ctx_of(seconds=1.0)
    c["trace"] = dict(busy_s=0.75, window_s=1.0)
    assert cell.reader("device_idle_share.train")(c) == pytest.approx(25.0)


@pytest.mark.parametrize("name,kid", [
    ("void forward_blend<128>(float const*, int const*)", "K1"), ("backward_blend(float*)", "K2"),
    ("void segment_sum<true>(float const*)", "K3"), ("scan_decode(int const*)", "K4"),
    ("unpack(float const*, float*)", "K5a"), ("pack(float const*, float*)", "K5b"),
    ("knn_rows_wide(float const*)", "K6"), ("knn_reverse(float const*)", "K7"),
    ("void knn_select<21>(float4 const*)", "X1"),
    ("void (anonymous namespace)::segment_sum<true>(float const*, int const*)", "K3"),
    ("(anonymous namespace)::forward_blend(float const*)", "K1"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>()", None),
    ("unpack_kernel(float*)", None)])
def test_kernel_ids_by_whole_name(name, kid):
    assert trace.kernel_id(name) == kid


def test_a_trace_that_lost_records_gives_no_share():
    t = dict(by_profiler={"K1": 3, "K2": 2}, counted={"K1": 3, "K2": 3}, device_ops=[])
    with pytest.raises(RuntimeError, match="disagree"):
        trace.check_counts(t)
    trace.check_counts(dict(by_profiler={"K1": 3}, counted={"K1": 3}))


def test_kernel_share_over_the_sampled_launches():
    w = dict(tiles=1000, rows=10_000, rows_read=10_000, live_rows=8000, evals=10 ** 8,
             includes=10 ** 7)
    k1 = 14 * 10 ** 8 + 45 * 10 ** 7         # ops: the larger bound here
    least = k1 / 67e12
    launches = [(0.0, 1e6 * 4 * least), (10.0, 1.0), (20.0, 1e6 * 4 * least)]
    c = dict(trace={"launches": {"K1": launches}}, work=[(0, w), (2, w)])
    assert shares.kernel_share(c, "K1") == pytest.approx(25.0)
    c["work"] = [(3, w)]
    assert shares.kernel_share(c, "K1") is None
