"""The program's layers by its own spans: device time by the innermost
span, a backward kernel by its forward op's sequence number, each idle
gap charged to the event that ends it, and each span's host time."""

import pytest

from benchmark import step_layers, trace

SEQ, FWD = "Sequence number", "Fwd thread id"


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def launch(ts, corr, tid=1):
    return x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
             correlation=corr)


def step_trace():
    """One step as the program spans it, with its backward on the engine's
    thread (tid 2) and the device on tid 7; times in µs."""
    return [
        x("user_annotation", "dvd/data_wait", 0, 1),
        x("user_annotation", "dvd/step", 2, 118),
        x("user_annotation", "dvd/loss", 3, 47),
        x("user_annotation", "dvd/depth_net", 4, 16),
        x("cpu_op", "aten::conv2d", 5, 10, **{SEQ: 5, FWD: 0}),
        launch(6, 1), launch(7, 10),
        x("user_annotation", "dvd/field", 22, 18),
        x("cpu_op", "ChainFn", 23, 12, **{SEQ: 6, FWD: 0}),
        launch(24, 2),
        x("cpu_op", "aten::mul", 42, 6, **{SEQ: 7, FWD: 0}),
        launch(43, 3),
        x("user_annotation", "dvd/backward", 52, 38),
        x("cpu_op", "autograd::engine::evaluate_function: "
          "ConvolutionBackward0", 60, 6, tid=2, **{SEQ: 5, FWD: 1}),
        launch(61, 4, tid=2),
        x("cpu_op", "autograd::engine::evaluate_function: "
          "ChainFnBackward", 67, 8, tid=2, **{SEQ: 6, FWD: 1}),
        launch(68, 5, tid=2),
        x("cpu_op", "autograd::engine::evaluate_function: MulBackward0",
          76, 4, tid=2, **{SEQ: 7, FWD: 1}),
        launch(77, 6, tid=2),
        x("user_annotation", "dvd/optim", 92, 18),
        x("user_annotation", "Optimizer.step#Adam.step", 93, 16),
        x("cpu_op", "aten::_foreach_addcdiv_", 94, 6),
        launch(95, 7),
        x("cuda_runtime", "cudaMemcpyAsync", 115, 1, correlation=8),
        # the device; corr 10 overlaps corr 1 on another stream
        x("kernel", "k1", 10, 8, tid=7, correlation=1),
        x("kernel", "k10", 12, 10, tid=8, correlation=10),
        x("kernel", "k2", 30, 4, tid=7, correlation=2),
        x("kernel", "k3", 45, 2, tid=7, correlation=3),
        x("kernel", "k4", 62, 6, tid=7, correlation=4),
        x("kernel", "k5", 68, 9, tid=7, correlation=5),
        x("kernel", "k6", 79, 1, tid=7, correlation=6),
        x("kernel", "k7", 97, 5, tid=7, correlation=7),
        x("gpu_memcpy", "Memcpy DtoH", 116, 2, tid=9, correlation=8),
    ]


def test_device_time_by_the_innermost_span_and_sequence_number():
    a = step_layers.analyze(step_trace())
    # depth_net: its two forward kernels and ConvolutionBackward0's; loss:
    # dvd/loss's self time, aten::mul and MulBackward0's kernel
    assert a["device_s"] == pytest.approx({
        "depth_net": 24e-6, "field": 13e-6, "loss": 3e-6, "optim": 5e-6,
        "other": 2e-6})


def test_each_gap_goes_to_the_event_that_ends_it():
    a = step_layers.analyze(step_trace())
    # depth_net: 0..10 and 47..62; field: 22..30 (after the union of k1
    # and k10); loss: 34..45 and 77..79; optim 80..97; other 102..116
    assert a["idle_s"] == pytest.approx({
        "depth_net": 25e-6, "field": 8e-6, "loss": 13e-6, "optim": 17e-6,
        "other": 14e-6})


def test_idle_by_layer_sums_to_the_stretch_less_busy():
    events = step_trace()
    a, t = step_layers.analyze(events), trace.analyze(events, {})
    assert sum(a["idle_s"].values()) == pytest.approx(
        t["window_s"] - t["busy_s"], rel=1e-12)
    assert sum(a["device_s"].values()) == pytest.approx(
        sum(t["layer_s"].values()), rel=1e-12)


def test_host_time_by_span_nested_included():
    # the device's copy of a span, from its first kernel to its last, is
    # not host time
    events = step_trace() + [
        x("gpu_user_annotation", "dvd/loss", 10, 37, tid=7),
        x("gpu_user_annotation", "dvd/backward", 62, 18, tid=7)]
    a = step_layers.analyze(events)
    assert a["host_s"] == pytest.approx({
        "dvd/loss": 47e-6, "dvd/depth_net": 16e-6, "dvd/field": 18e-6,
        "dvd/backward": 38e-6, "dvd/optim": 18e-6})


def test_no_device_events_reads_nothing():
    events = [e for e in step_trace() if e["cat"] not in trace.DEVICE_CATS]
    assert step_layers.analyze(events) == {}
