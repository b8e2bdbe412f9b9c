"""Percentiles, the judgement of ``correct``, the window and the
reduction of a trace's intervals."""

import numpy as np
import pytest

from portbench import harness, layers, trace
from portbench.drivers import common


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 100, 541])
def test_percentile_is_numpys_linear(q, n):
    values = list(np.random.RandomState(n).lognormal(size=n))
    assert harness.percentile(values, q) == pytest.approx(float(np.percentile(values, q)), rel=1e-12)


def test_judge_fails_a_missing_or_large_or_nan_number():
    limits = {"a": 1.0, "b": 2.0}
    assert harness.judge({"a": 0.5, "b": 2.0}, limits)[0]
    assert not harness.judge({"a": 0.5, "b": 2.5}, limits)[0]
    assert not harness.judge({"a": 0.5}, limits)[0]
    assert not harness.judge({"a": float("nan"), "b": 0.0}, limits)[0]
    ok, compared = harness.judge({"a": 0.5, "b": 1.0, "c": 9.0}, limits)
    assert list(compared) == ["a", "b"] and compared["a"] == {"value": 0.5, "limit": 1.0}


def test_window_counts_every_unit_and_all_its_time():
    calls = []
    win = common.window(lambda i: calls.append(i), 3, 0.05, "cpu")
    assert calls == list(range(3, 3 + win["units"])) and win["first"] == 3
    assert win["seconds"] >= 0.05 and win["units"] >= 1


def test_busy_time_is_a_union_of_intervals():
    assert trace._merge([(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]) == [(0, 3), (5, 7), (10, 11)]


def test_kinds_put_the_ports_kernels_first():
    assert trace.kind_of("void (anonymous namespace)::conv_tc<__nv_bfloat16, 9, 1, 2>(ConvArgs)") == "fused_resnet_block"
    assert trace.kind_of("sm80_xmma_fprop_implicit_gemm_f32f32_cudnn") == "conv"
    assert trace.kind_of("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert trace.kind_of("la_cluster<32>") == "linear_attention"


def test_per_layer_arithmetic():
    tr = {"units": 4, "window_s": 1.0, "busy_s": 0.3, "launches": 400,
          "kinds_ms": {"linear_attention": 2.0, "conv": 100.0, "elementwise": 30.0, "reduction": 10.0}}
    view = {"unit": "train", "units": 10, "window_s": 1.0, "flops_per_unit": 5e12, "peak_flops": 1e15,
            "bounds_ms": {"linear_attention": 0.25, "linear_attention_backward": 1.0}, "trace": tr}
    assert layers.mfu(view, "train") == pytest.approx(5.0)
    assert layers.kernel_roofline(view, "train") == pytest.approx(50.0)  # 4 x 0.25 of 2.0; the unseen kernel left out
    assert layers.kinds_ms(view, "train", "elementwise", "reduction") == pytest.approx(10.0)
    assert layers.idle_share(view, "train") == pytest.approx(25.0)  # 0.075 s busy of 0.1 s a unit
    assert layers.launches(view, "train") == 100
    assert layers.mfu(view, "serve") is None and layers.launches(view, "serve") is None
