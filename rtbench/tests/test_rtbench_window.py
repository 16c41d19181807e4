"""The window's arithmetic on synthetic timestamps and traces: the rate,
the p95 rule, the union of device intervals, the idle gaps, the kernel
classifier and the per-layer readers."""

from __future__ import annotations

import pytest

from rtbench import roofline, spec, tracing, window


def test_frame_ms_is_a_rate_over_the_window():
    t0 = 100.0
    done = [t0 + 0.1 * (k + 1) for k in range(10)] + [None]
    assert window.frame_ms(t0, done, t_end=t0 + 0.55) == pytest.approx(100.0)
    # Frames done after the close do not count; the span ends at the last one done in it.
    assert window.frame_ms(t0, done, t_end=t0 + 1.05) == pytest.approx(100.0)
    assert window.frame_ms(t0, [None, None], t_end=t0 + 1.0) is None


def test_p95_is_nearest_rank_over_frames_done():
    call = [float(k) for k in range(200)]
    done = [c + (1.0 if k < 190 else 2.0) for k, c in enumerate(call)]
    assert window.latency_ms_p95(call, done, t_end=1e9) == pytest.approx(1000.0)
    done[189] = call[189] + 2.0  # 11 slow frames: the 95th percentile is slow
    assert window.latency_ms_p95(call, done, t_end=1e9) == pytest.approx(2000.0)
    assert window.percentile([], 95) is None
    assert window.percentile([3.0, 1.0, 2.0], 100) == 3.0


def test_union_busy_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert window.merge(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert window.busy(iv, 0.0, 10.0) == 4.0
    assert window.busy(iv, 1.0, 5.5) == 2.5
    assert window.gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 10.0)]
    assert window.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::segment_walk_kernel<16, 24>(float const*, int)", "traversal"),
    ("void (anonymous namespace)::traverse_walk_any_kernel<16, 12>(Ray)", "traversal"),
    ("rounds_pick_kernel", "traversal"),
    ("void (anonymous namespace)::wide_walk_kernel<false>(float const*)", "traversal"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int)", "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>(int)", "gather/scatter"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int)", "sort"),
    ("void at::native::reduce_kernel<512, 1>(int)", "reduction"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(int)", "cat"),
    ("void at::native::segment_reduce_forward_kernel<float>(int)", "reduction"),
    ("void (anonymous namespace)::shade_kernel<1, 3>(ShadeArgs)", "shade"),
    ("void (anonymous namespace)::pass_mark_kernel<2>()", "marker"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_kernel_classifier(name, kind):
    assert window.kind(name) == kind


def _ctx():
    kernels = [("void (anonymous namespace)::traverse_walk_kernel<16, 12>(x)", 0.0, 40.0),
               ("void at::native::vectorized_elementwise_kernel<4>(x)", 50.0, 30.0),
               ("void at::native::index_elementwise_kernel<128, 4>(x)", 80.0, 10.0),
               ("void (anonymous namespace)::traverse_walk_any_kernel<16, 12>(x)", 100.0, 20.0)]
    dev = [(n, s, d, "kernel") for n, s, d in kernels] + [("Memcpy HtoD", 125.0, 5.0, "gpu_memcpy")]
    return {"window_us": (0.0, 200.0), "device_ops": dev, "kernels": kernels,
            "host": [("cudaGraphLaunch", 120.0, 70.0), ("rtbench:stretch", 0.0, 200.0)], "frames": 2,
            "traced_rays": [1000, 3000], "device_name": "NVIDIA H100 80GB HBM3"}


def test_readers_on_a_synthetic_trace():
    ctx = _ctx()
    read = {n: spec.metric_reader(n)(ctx) for n in ("device_idle_pct", "traverse_ms", "shading_chain_ms",
                                                     "kernels_per_frame", "traverse_roofline_pct")}
    assert read["device_idle_pct"] == pytest.approx(100.0 * (1 - 105.0 / 200.0))
    assert read["traverse_ms"] == pytest.approx(60.0 / 2 / 1e3)
    assert read["shading_chain_ms"] == pytest.approx(40.0 / 2 / 1e3)
    assert read["kernels_per_frame"] == 2.0
    floor = roofline.ray_bytes(4000) / 3.35e12
    assert read["traverse_roofline_pct"] == pytest.approx(100.0 * floor / 60e-6)
    assert tracing.busy_window_s(ctx) == pytest.approx((105e-6, 200e-6))
    assert tracing.kinds(ctx) == pytest.approx({"traversal": 0.03, "elementwise": 0.015, "gather/scatter": 0.005})
    bd = tracing.breakdown(ctx)
    assert bd["device_ops"][0][0].startswith("void (anonymous namespace)::traverse_walk_kernel")
    assert bd["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(70e-6)]


def test_readers_find_nothing_in_an_empty_trace():
    ctx = dict(_ctx(), device_ops=[], kernels=[], traced_rays=None)
    for n in ("device_idle_pct", "traverse_ms", "shading_chain_ms", "kernels_per_frame", "traverse_roofline_pct"):
        assert spec.metric_reader(n)(ctx) is None


def test_roofline_bytes_per_ray():
    assert roofline.ray_bytes(1) == 44
    assert roofline.traversal_floor_s(3_350_000_000, "NVIDIA H100 80GB HBM3") == pytest.approx(0.044)
