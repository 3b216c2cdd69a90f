"""The metric arithmetic: the window's rate and batch tail, the card's
busy time and breakdown from a profile, and each per-layer reader on a
window's numbers."""

import types

import numpy as np
import pytest

from portbench import harness, registry


def test_end_to_end_arithmetic():
    lat = list(np.arange(1, 201, dtype=float))          # 200 batches
    e = harness.end_to_end(reads=200 * 8192, window_s=40.0, lat_ms=lat,
                           rss_gib=7.5, setup_s=61.0)
    assert e["reads_per_s"] == pytest.approx(200 * 8192 / 40.0)
    # linear between order statistics: rank 0.95 * 199 = 189.05
    assert e["batch_p95_ms"] == pytest.approx(190.05)
    assert e["host_rss_peak_gib"] == 7.5 and e["setup_s"] == 61.0
    assert harness.end_to_end(0, 1.0, [], 1.0, 1.0)["batch_p95_ms"] is None


def _fake_profile():
    """A profile of two device kernels, a copy and host calls."""
    from torch.autograd import DeviceType

    def ev(name, a, b, dev):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(
                start=a, end=b, elapsed_us=lambda a=a, b=b: b - a))

    evs = [ev("extd2_fwd_kernel<64>", 0, 100, DeviceType.CUDA),
           ev("extd2_tb_kernel", 50, 150, DeviceType.CUDA),
           ev("Memcpy HtoD", 400, 450, DeviceType.CUDA),
           ev("cudaGraphLaunch", 0, 20, DeviceType.CPU),
           ev("cudaEventSynchronize", 150, 390, DeviceType.CPU)]
    ka = [types.SimpleNamespace(key="cudaGraphLaunch", count=1,
                                self_cpu_time_total=20.0)]
    return types.SimpleNamespace(events=lambda: evs, key_averages=lambda: ka)


def test_busy_time_matches_the_program():
    """The union of device intervals equals the program's own
    (ops/kernel_bounds.device_activity) on the same profile."""
    from pansvr_tpu_torch.ops import kernel_bounds as kb

    prof = _fake_profile()
    busy, _, _, _ = harness.device_breakdown(prof)
    assert busy == pytest.approx(200e-6)           # union 0-150, 400-450
    assert busy == pytest.approx(kb.device_activity(prof, 0.001)["busy_s"])


def test_breakdown_names_kernels_and_idle_gaps():
    _, by_name, ops, idle = harness.device_breakdown(_fake_profile())
    assert ops[0] == ["extd2_fwd_kernel<64>", pytest.approx(100e-6)]
    assert idle == [["cudaEventSynchronize", pytest.approx(250e-6)]]
    assert by_name["Memcpy HtoD"] == pytest.approx(50e-6)


def test_per_layer_readers():
    prof = dict(prep_s=30.0, host_submit=10.0, host_collect=2.0,
                host_replay=3.0, sync_chain=1.0, dp_dispatch=2.5, sync_dp=1.5,
                n_graph_capture=0.0, n_retry=2.0)
    ctx = dict(window_s=40.0, prof=prof, prof_total=dict(index_upload=8.9),
               busy_s=1.6,
               kernel_s={"void (anonymous namespace)::extd2_fwd_kernel<2, 4>(x)": 0.3,
                         "void extd2_tb_kernel(y)": 0.1,
                         "other": 5.0},
               dp_kernels=harness.DP_KERNELS)
    want = dict(prep_wall_pct=75.0, submit_pct=25.0, replay_emit_pct=12.5,
                front_wait_pct=2.5, dp_pct=10.0, dp_kernels_pct=1.0,
                graph_captures=0, batch_retries=2, device_idle_pct=96.0,
                index_upload_s=8.9)
    for name, v in want.items():
        assert registry.metric_reader(name)(ctx) == pytest.approx(v), name
    # nothing to read: no trace, no kernel
    empty = dict(ctx, busy_s=None, kernel_s={})
    assert registry.metric_reader("device_idle_pct")(empty) is None
    assert registry.metric_reader("dp_kernels_pct")(empty) is None
