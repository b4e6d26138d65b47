"""The yardstick's counting rules, the trace reduction and the readers."""

from __future__ import annotations

import math

import pytest
import torch

from harness import counting, readers, trace
from harness.reference import geodesic_scan as G
from harness.runner import Readings

BASIC = {"input_shape": [32, 32, 64], "num_classes": 2, "conv_layers": [[128, 3], [64, 3]],
         "hidden_units": [256, 128], "dropout_rate": 0.3, "leaky_alpha": 0.01,
         "conv_padding": "VALID"}
ADVANCED = dict(BASIC, input_shape=[256, 256, 64], conv_layers=[[32, 3], [64, 3]],
                conv_padding="SAME")


def test_conv_leaky_work_counts_each_product_and_byte_once():
    flops, nbytes = counting.conv_leaky_work(2, 5, 6, 3, 4, 3, "VALID")
    assert flops == 2 * (2 * 3 * 4) * 4 * (3 * 3 * 3)      # 2 FLOPs a multiply-add
    assert nbytes == 4 * (2 * 5 * 6 * 3 + 4 * 3 * 9 + 4 + 2 * 3 * 4 * 4)
    flops_same, _ = counting.conv_leaky_work(2, 5, 6, 3, 4, 3, "SAME")
    assert flops_same == 2 * (2 * 5 * 6) * 4 * 27


def test_conv_leaky_bound_is_tf32_dense_per_call():
    """Float32 products are bounded at 495 TFLOP/s (tensor-core TF32), so
    an exact-float32 tensor-core kernel stays under 100%; each call's
    bound is the larger of its FLOPs and its bytes, and the calls add."""
    calls = counting.conv_leaky_calls(BASIC, 256)
    expect = sum(max(f / 495e12, b / 3.35e12) for f, b in calls)
    assert counting.conv_leaky_bound_s(BASIC, 256) == pytest.approx(expect)
    # layer 1 of the bulk cell is bound by its FLOPs at the TF32 rate
    f, b = calls[0]
    assert f / 495e12 > b / 3.35e12
    assert counting.conv_leaky_bound_s(BASIC, 256) < sum(f / 67e12 for f, _ in calls)
    # the advanced layers at B=32 are bound by bytes
    f, b = counting.conv_leaky_calls(ADVANCED, 32)[0]
    assert b / 3.35e12 > f / 495e12


def test_model_flops():
    fwd = counting.classifier_forward_flops(ADVANCED)
    assert fwd == pytest.approx(2 * 256 * 256 * 32 * 64 * 9 + 2 * 128 * 128 * 64 * 32 * 9
                                + 2 * 64 * 64 * 64 * 256 + 2 * 256 * 128 + 2 * 128 * 2)
    assert counting.train_model_flops(ADVANCED) == 3 * fwd
    per_img = counting.bulk_model_flops(BASIC, 256, 2)
    assert per_img == pytest.approx(counting.conv1_flops(256, 256)
                                    + counting.classifier_forward_flops(BASIC)
                                    + 2 * counting.head_backward_flops(BASIC))
    assert 0.25e9 < per_img < 0.28e9
    r = Readings({}, None, {}, window_units=10, window_s=2.0, model_flops_per_unit=1e12)
    assert readers.mfu(r) == pytest.approx(100 * 5e12 / 495e12)


def _pair_inputs():
    """A smooth ramp with two markers: the pair form's fixpoint comes in a
    few sweeps, far below the cap of 256."""
    h, w = 24, 40
    img = torch.arange(w, dtype=torch.float32).repeat(h, 1)[None] % 7
    markers = torch.zeros((1, h, w), dtype=torch.int32)
    markers[0, 3, 2], markers[0, 20, 37] = 1, 2
    return img, markers


def test_pair_watershed_counts_the_sweeps_the_inputs_need():
    img, markers = _pair_inputs()
    sweeps = G.sweeps_to_fixpoint(img, markers, 256, 8)
    assert 1 < sweeps < 256
    ops, nbytes = counting.watershed_pair_work(24, 40, sweeps)
    assert ops == 56 * 24 * 40 * sweeps and nbytes == 13 * 24 * 40
    assert counting.watershed_pair_bound_s(24, 40, sweeps) < \
        counting.watershed_pair_bound_s(24, 40, 256)
    # capped at JAX's 256 where the inputs would need more
    assert G.sweeps_to_fixpoint(img, markers, 3, 8) == 3


def test_pair_sweeps_needed_runs_the_cleaners_own_inputs():
    from harness import synthetic
    from harness.reference import cleaner

    gen = torch.Generator().manual_seed(3)
    x = synthetic.native_mammogram(80, 64, gen).to(torch.float32)
    (sweeps,) = cleaner.pair_sweeps_needed(x[None])
    img_equ, markers = cleaner.pectoral_watershed_inputs(x[None])
    assert sweeps == G.sweeps_to_fixpoint(img_equ.float(), markers, 256, 8)
    assert 1 <= sweeps <= 256


def _stats(group_s, busy=0.5, window=1.0, complete=True, units=2):
    return trace.TraceStats(complete, 3, 3 if complete else 2, units, window, busy, {},
                            group_s, {})


def test_roofline_share_reads_only_what_is_there():
    r = Readings({}, _stats({"conv_leaky": 0.004}), {"conv_leaky": 0.001}, 1, 1.0, 0.0)
    assert readers.roofline_share(r, "conv_leaky") == pytest.approx(25.0)
    # no device time, no counted work, or an incomplete trace: nothing, never 0
    for rr in (Readings({}, _stats({"conv_leaky": 0.0}), {"conv_leaky": 0.001}, 1, 1.0, 0.0),
               Readings({}, _stats({"conv_leaky": 0.004}), {}, 1, 1.0, 0.0),
               Readings({}, _stats({"conv_leaky": 0.004}, complete=False),
                        {"conv_leaky": 0.001}, 1, 1.0, 0.0),
               Readings({}, None, {"conv_leaky": 0.001}, 1, 1.0, 0.0)):
        assert readers.roofline_share(rr, "conv_leaky") is None
    assert readers.idle_share(Readings({}, _stats({}, busy=0.25), {}, 1, 1.0, 0.0)) == 75.0
    assert readers.idle_share(Readings({}, _stats({}, busy=0.0), {}, 1, 1.0, 0.0)) is None
    assert readers.group_device_ms(
        Readings({}, _stats({"cleaner": 0.006}, units=3), {}, 1, 1.0, 0.0), "cleaner") == \
        pytest.approx(2.0)
    assert readers.span_median_ms(Readings({"x": [0.001, 0.003, 0.002]}, None, {}, 1, 1, 0),
                                  "x") == pytest.approx(2.0)


@pytest.mark.parametrize("name, base", [
    ("void (anonymous namespace)::ccl_local<8>(unsigned char const*, int*, int, int)",
     "ccl_local"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)"
     "::Foo<float>, std::array<char*, 2ul> >(int, Foo<float>, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel"),
    ("conv_leaky_kernel", "conv_leaky_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32",
     "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32"),
])
def test_base_name(name, base):
    assert trace.base_name(name) == base


def test_kernel_groups_name_the_ports_kernels():
    groups = trace.load_groups()
    assert groups["watershed_pair"] <= groups["cleaner"]
    assert "conv_leaky_kernel" in groups["conv_leaky"]


def _ev(name, cat, ts, dur, ph="X"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": ph}


def test_reduce_events_busy_idle_and_completeness():
    groups = {"g": {"k1"}}
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        _ev("portbench.enqueue", "user_annotation", 0, 60),
        _ev("cudaLaunchKernel", "cuda_runtime", 1, 1),
        _ev("cuLaunchKernel", "cuda_driver", 2, 1),
        _ev("void k1<1>(int)", "kernel", 10, 20),
        _ev("k2", "kernel", 20, 20),          # overlaps k1: busy 10..40
        _ev("Memcpy DtoH", "gpu_memcpy", 70, 10),
    ]
    s = trace.reduce_events(events, 2, groups)
    assert s.complete and s.launches == 2 and s.kernels == 2
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.group_s["g"] == pytest.approx(20e-6)
    # idle gaps 0..10 and 40..70 (named by the span open at their middle:
    # enqueue) and 80..100 (none)
    assert s.idle_by_span["portbench.enqueue"] == pytest.approx(40e-6)
    assert s.idle_by_span["no span"] == pytest.approx(20e-6)
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    lost = trace.reduce_events(events[:-3] + events[-2:], 2, groups)
    assert not lost.complete


def test_nearest_rank_p95_counts_failures_as_misses():
    from harness.kinds.upload import nearest_rank

    lat = [0.01] * 95 + [0.02] * 5
    assert nearest_rank(lat, 0.95) == 0.01
    assert nearest_rank(lat + [math.inf] * 5, 0.95) == 0.02
    assert nearest_rank([0.01] * 90 + [math.inf] * 10, 0.95) == math.inf


def test_tf32_rounding():
    from harness.reference.model import TF32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.0000002])
    y = TF32.rnd(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]
    x = torch.randn(1000, requires_grad=True)
    TF32.rnd(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(1000))
