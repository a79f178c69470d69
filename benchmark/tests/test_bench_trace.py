"""The trace attribution puts device time in layers by launch correlation
and autograd sequence numbers, not by kernel names."""

import pytest

from benchmark import trace

LAYERS = {"bench/depth_net": "depth_net", "bench/field": "field"}


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def tiny_trace():
    """A step: the depth net's conv, the field's chain, a loss op, the
    backward of each on the engine's thread, and a copy; kernel names are
    deliberately misleading."""
    seq, fwd = "Sequence number", "Fwd thread id"
    ev = [
        x("user_annotation", "dvd/data_wait", 0, 1),
        x("user_annotation", "dvd/step", 2, 100),
        x("user_annotation", "bench/depth_net", 3, 20),
        x("cpu_op", "aten::conv2d", 4, 10, **{seq: 5, fwd: 0}),
        x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        x("user_annotation", "bench/field", 25, 20),
        x("cpu_op", "ChainFunction", 26, 10, **{seq: 6, fwd: 0}),
        x("cuda_runtime", "cudaLaunchKernel", 27, 1, correlation=2),
        x("cpu_op", "aten::mul", 50, 5, **{seq: 7, fwd: 0}),
        x("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        x("cpu_op", "autograd::engine::evaluate_function: "
          "ConvolutionBackward0", 60, 10, tid=2, **{seq: 5, fwd: 1}),
        x("cuda_runtime", "cudaLaunchKernel", 61, 1, tid=2, correlation=4),
        x("cpu_op", "autograd::engine::evaluate_function: "
          "ChainFunctionBackward", 71, 10, tid=2, **{seq: 6, fwd: 1}),
        x("cuda_runtime", "cudaLaunchKernel", 72, 1, tid=2, correlation=5),
        x("cpu_op", "autograd::engine::evaluate_function: MulBackward0",
          82, 5, tid=2, **{seq: 7, fwd: 1}),
        x("cuda_runtime", "cudaLaunchKernel", 83, 1, tid=2, correlation=6),
        x("cuda_runtime", "cudaMemcpyAsync", 90, 1, correlation=7),
        # the device: misleading names
        x("kernel", "chain_bwd_points", 10, 8, tid=7, correlation=1),
        x("kernel", "cudnn_fprop", 30, 4, tid=7, correlation=2),
        x("kernel", "mlp_fwd", 52, 2, tid=7, correlation=3),
        x("kernel", "loss_bwd", 62, 6, tid=7, correlation=4),
        x("kernel", "wgrad", 73, 9, tid=7, correlation=5),
        x("kernel", "elementwise", 84, 1, tid=7, correlation=6),
        x("gpu_memcpy", "Memcpy DtoH", 91, 2, tid=8, correlation=7),
    ]
    return ev


def test_layers_by_launch_and_sequence_number():
    a = trace.analyze(tiny_trace(), LAYERS)
    assert a["layer_s"] == pytest.approx({"depth_net": 14e-6,
                                          "field": 13e-6,
                                          "other": 5e-6})
    assert a["unlinked"] == 0 and a["device_events"] == 7


def test_busy_window_and_idle_gaps():
    a = trace.analyze(tiny_trace(), LAYERS)
    busy = 8 + 4 + 2 + 6 + 9 + 1 + 2
    assert a["busy_s"] == pytest.approx(busy * 1e-6)
    assert a["window_s"] == pytest.approx(93e-6)  # data_wait at 0 .. 93
    idle = dict(a["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((93 - busy) * 1e-6)
    assert set(idle) <= {"dvd/step", "dvd/data_wait", "none"}


def test_an_unlaunched_event_is_other():
    ev = tiny_trace() + [x("kernel", "orphan", 95, 1, tid=7,
                           correlation=99)]
    a = trace.analyze(ev, LAYERS)
    assert a["unlinked"] == 1
    assert a["layer_s"]["other"] == pytest.approx(6e-6)


def test_no_device_events_reads_nothing():
    ev = [e for e in tiny_trace() if e["cat"] not in trace.DEVICE_CATS]
    assert trace.analyze(ev, LAYERS) == {}


# Recorded on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128): after three
# warm-up steps, one step under torch.profiler (CPU and CUDA) of
#   with dvd/step:
#       with bench/depth_net: d = conv(x)   # Conv2d(3,8,3) ReLU Conv2d(8,1,3)
#       with bench/field: f = lin(d.permute(0,2,3,1).expand(..., 4)
#                                 .reshape(-1, 4))  # Linear LeakyReLU Linear
#       loss = (f * f).mean() + d.mean(); loss.backward()
# at x [2,3,16,16], trimmed to the events and arguments the attribution
# reads. Which layer each op belongs to follows from that program alone.
RECORDED_OPS = {
    "depth_net": {"aten::conv2d", "aten::relu", "ConvolutionBackward0",
                  "ReluBackward0"},
    "field": {"aten::linear", "aten::leaky_relu", "AddmmBackward0",
              "LeakyReluBackward0", "ExpandBackward0", "PermuteBackward0"},
    "other": {"aten::mul", "aten::mean", "aten::add", "aten::ones_like",
              "MeanBackward0", "MulBackward0",
              "torch::autograd::AccumulateGrad"},
}


def test_a_recorded_h100_trace_splits_by_layer():
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "data",
                        "tiny_trace_h100.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    att = trace.Attribution(events, LAYERS)
    device = [e for e in events if e["cat"] in trace.DEVICE_CATS]
    assert len(device) == 50
    seen = {"depth_net": 0, "field": 0, "other": 0}
    for e in device:
        layer = att.layer(e)
        assert att.op_name(e) in RECORDED_OPS[layer], (e["name"], layer)
        seen[layer] += 1
    # the backward kernels ran on the autograd engine's thread
    assert seen == {"depth_net": 11, "field": 21, "other": 18}
    a = trace.analyze(events, LAYERS)
    assert a["unlinked"] == 0
    assert a["busy_s"] < a["window_s"]
