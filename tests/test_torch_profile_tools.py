"""The step profile and the convolution roofline (``tools/step_profile.py``,
``tools/roofline.py``) on the CPU: ``analyze`` on a hand-built trace whose
answers are known, on a CPU trace of a tiny step (no device events: "not
measured", exit 1); the roofline's shapes collected from ``MidasNet``
against ``torch.utils.flop_counter``; both timing paths raise without a
card. The card tests (marked ``cuda``) time one shape on the card."""

import json

import pytest
import torch

from dynamic_video_depth_tpu_torch.tools import roofline, step_profile
from torch_threads import one_torch_thread  # noqa: F401


def _span(name, tid, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(corr, tid, ts, name, dev_ts, dur, cat="kernel"):
    return [_span("cudaLaunchKernel", tid, ts, 2, "cuda_runtime",
                  correlation=corr),
            {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
             "ts": dev_ts, "dur": dur, "args": {"correlation": corr}}]


def hand_trace():
    """Two steps. Step 1: a convolution forward (implicit GEMM), its
    backward on the autograd thread (an FFT kernel that names no direction,
    a wgrad kernel), kernel A, an optimizer kernel, a copy and an
    elementwise kernel; step 2: one GEMM; one kernel outside any step."""
    fwd_args = {"Input Dims": [[2, 3, 8, 8], [4, 3, 3, 3]] + [[]] * 7,
                "Concrete Inputs": ["", "", "", "[1, 1]", "[1, 1]",
                                    "[1, 1]", "False", "[0, 0]", "1"]}
    bwd_args = {"Input Dims": [[2, 4, 8, 8], [2, 3, 8, 8], [4, 3, 3, 3]]
                + [[]] * 8,
                "Concrete Inputs": ["", "", "", "[4]", "[1, 1]", "[1, 1]",
                                    "[1, 1]", "False", "[0, 0]", "1",
                                    "[True, True, True]"]}
    ev = [_span("dvd/step", 1, 0, 1000), _span("dvd/step", 1, 2000, 1000),
          _span("aten::conv2d", 1, 5, 110, "cpu_op"),
          _span("aten::convolution", 1, 10, 100, "cpu_op", **fwd_args),
          _span("aten::convolution_backward", 2, 300, 100, "cpu_op",
                **bwd_args),
          _span("Optimizer.step#Adam.step", 1, 700, 100)]
    ev += _launch(1, 1, 20, "sm90_xmma_fprop_implicit_gemm_f32f32_nhwc",
                  100, 50)
    ev += _launch(2, 2, 310, "void fft2d_r2c_32x32<float>(float2*)", 400, 30)
    ev += _launch(3, 2, 320, "sm80_xmma_wgrad_implicit_gemm_indexed", 430,
                  20)
    ev += _launch(4, 1, 500, "void warp_fwd<4>(float const*, float*)", 600,
                  10)
    ev += _launch(5, 1, 710, "void at::native::(anonymous namespace)::"
                  "multi_tensor_apply_kernel<float>(float*)", 800, 40)
    ev += _launch(6, 1, 900, "Memcpy HtoD (Pageable -> Device)", 900, 10,
                  "gpu_memcpy")
    ev += _launch(7, 1, 910, "void at::native::vectorized_elementwise_"
                  "kernel<4>(int)", 920, 30)
    ev += _launch(8, 1, 1500, "void stray_kernel()", 1600, 50)
    ev += _launch(9, 1, 2010, "ampere_sgemm_128x64_nn", 2100, 100)
    return ev


def test_analyze_splits_a_hand_built_trace():
    r = step_profile.analyze(hand_trace(), "Card X, 700.00 W", top=3)
    assert r["n_steps"] == 2
    assert r["step_spans_ms"] == pytest.approx([0.85, 0.1])
    assert r["busy_ms"] == pytest.approx(0.145)
    assert r["busy_share"] == pytest.approx(290 / 950)
    assert r["idle_share"] == pytest.approx(660 / 950)
    cats = {k: v["ms"] for k, v in r["by_category"].items()}
    assert cats == pytest.approx({
        "conv fwd, implicit_gemm": 0.025, "conv bwd, fft": 0.015,
        "conv wgrad, implicit_gemm": 0.010, "A warp": 0.005,
        "optimizer": 0.020, "memcpy": 0.005,
        "elementwise/reduction": 0.015, "gemm": 0.050})
    assert r["conv_ms"] == pytest.approx(0.05)
    (row,) = r["conv_by_shape"]
    assert row["shape"] == "x[2,3,8,8] w[4,3,3,3] s[1,1] p[1,1] d[1,1] g1"
    assert row["ms"] == pytest.approx(0.05)
    assert (row["conv fwd"], row["conv bwd"], row["conv wgrad"]) == \
        pytest.approx((0.025, 0.015, 0.010))
    assert [t["name"] for t in r["top_kernels"]] == [
        "ampere_sgemm_128x64_nn", "sm90_xmma_fprop_implicit_gemm_f32f32_nhwc",
        "at::native::multi_tensor_apply_kernel<float>"]
    assert r["card"] == "Card X, 700.00 W"


def test_analyze_only_reads_a_trace_directory(tmp_path, capsys):
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": hand_trace(),
                   "deviceProperties": [{"name": "Card X"}]}, f)
    assert step_profile.main(["--analyze-only", "--out", str(tmp_path),
                              "--json"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["card"] == "Card X, power limit not recorded"
    (tmp_path / "card.txt").write_text("Card X, 650.00 W\n")
    assert step_profile.main(["--analyze-only", "--out", str(tmp_path)]) \
        == 0
    out = capsys.readouterr().out
    assert "card: Card X, 650.00 W" in out and "idle share 0.6947" in out


def test_analyze_of_a_cpu_trace_says_not_measured(tmp_path, capsys):
    """A tiny step traced on the CPU (``runtime/profiling.py``, as the
    trainer's ``--profile_dir``) has no device events."""
    from dynamic_video_depth_tpu_torch.runtime import profiling
    from dynamic_video_depth_tpu_torch.train import (
        LossConfig, SceneFlowMotionFieldStep, TrainStepConfig)

    step = SceneFlowMotionFieldStep(TrainStepConfig(
        depth_net="tiny", net_width=16, n_layers=1, n_freq_xyz=2,
        n_freq_t=1, loss=LossConfig(use_disp=True)), device="cpu")
    batch = step_profile.synthetic_pair(str(tmp_path / "track"), 1, 32, 48,
                                        "cpu")
    assert batch["img_1"].shape == (1, 32, 48, 3)
    with profiling.trace_if(str(tmp_path / "trace")):
        for _ in range(2):
            with profiling.annotate(step_profile.STEP_SPAN):
                step.train_step(batch, steps=1, warm=False)
    assert step_profile.main(["--analyze-only", "--out",
                              str(tmp_path / "trace")]) == 1
    assert "not measured" in capsys.readouterr().out
    events, _, _ = step_profile.load_trace(str(tmp_path / "trace"))
    with pytest.raises(step_profile.NotMeasured):
        step_profile.analyze(events, "cpu")


def test_roofline_shapes_count_the_flops_of_midas():
    """The hooks' shapes at 224x384, two frames: 125 convolutions of 30
    shapes whose FLOPs sum to ``FlopCounterMode``'s for the same forward;
    only the stem takes no input gradient."""
    from torch.utils.flop_counter import FlopCounterMode

    from dynamic_video_depth_tpu_torch.models import MidasNet

    shapes = roofline.conv_shapes(224, 384, 2)
    assert sum(s["count"] for s in shapes) == 125 and len(shapes) == 30
    assert [s["input"][1] for s in shapes if not s["dgrad"]] == [3]
    ours = sum(roofline.conv_flops(s) * s["count"] for s in shapes)
    net = MidasNet(generator=torch.Generator().manual_seed(0)).to("meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.empty(2, 224, 384, 3, device="meta"))
    assert ours == fc.get_flop_counts()["Global"][torch.ops.aten.convolution]
    assert ours == 241_367_777_280


def test_roofline_calls_are_the_convolution_and_its_gradients():
    """The three timed calls of a shape compute the forward and the two
    gradients that autograd gives (on the CPU, float64)."""
    import torch.nn.functional as F

    s = {"input": (2, 8, 10, 12), "output": (2, 8, 5, 6), "kernel": (3, 3),
         "stride": (2, 2), "padding": (1, 1), "dilation": (1, 1),
         "groups": 2, "bias": True, "dgrad": True}
    fns = roofline.calls(s, torch.float64, torch.device("cpu"))
    x, wt, bias, gy = fns["inputs"]
    xr, wr = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    y = F.conv2d(xr, wr, bias, 2, 1, 1, 2)
    y.backward(gy)
    assert torch.equal(fns["fwd"](), y.detach())
    torch.testing.assert_close(fns["dgrad"]()[0], xr.grad)
    torch.testing.assert_close(fns["wgrad"]()[1], wr.grad)
    assert roofline.conv_flops(s) == 2 * 2 * 5 * 6 * 8 * 4 * 9
    assert roofline.label(s) == "3x3/2 g2 8->8 @10x12 +bias"


def test_roofline_names_the_kernels_of_each_span():
    """Kernels link to the ``roofline/<i>`` span their launch sits in (the
    convolution op between them, a second launch of the same kernel, a
    kernel outside every span)."""
    ev = [_span("roofline/0", 1, 0, 100), _span("roofline/1", 1, 200, 100),
          _span("aten::convolution", 1, 10, 50, "cpu_op")]
    ev += _launch(1, 1, 20, "void fft2d_r2c_32x32<float>(float2*)", 30, 5)
    ev += _launch(2, 1, 30, "sm80_xmma_gemm_cf32cf32_f32f32", 40, 5)
    ev += _launch(3, 1, 40, "void fft2d_r2c_32x32<float>(float2*)", 50, 5)
    ev += _launch(4, 1, 210, "cudnn::cnn::wgrad2d_grouped_direct_kernel", 220,
                  5)
    ev += _launch(5, 1, 400, "void stray_kernel()", 410, 5)
    names = roofline.span_kernels(ev, 3)
    assert names == [["fft2d_r2c_32x32<float>", "sm80_xmma_gemm_cf32cf32_"
                      "f32f32"], ["cudnn::cnn::wgrad2d_grouped_direct_"
                                  "kernel"], []]
    assert [roofline.algorithm_class(n) for n in names] == [
        "fft", "direct", "not recorded"]


def test_timing_paths_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        step_profile.capture(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        roofline.run("float32")
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        roofline.main(["--dtype", "bfloat16"])
    assert not (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("name,want", [
    ("void fft2d_r2c_32x32<float, false, 1u>(float2*)", "fft"),
    ("cutlass_80_tensorop_cf32_cgemm_64x64", "fft"),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4", "winograd"),
    ("sm90_xmma_fprop_implicit_gemm_tf32f32", "implicit_gemm"),
    ("void implicit_convolve_sgemm<float, 1024, 5>", "implicit_gemm"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>", "direct"),
    ("DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>", "fft"),
    ("internal::region_transform_ABC_val<int, 32, 32, false>", "fft"),
    ("cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_"
     "optimized_bf16_256x64_32x4_nhwc_align8>", "implicit_gemm"),
    ("nvjet_tst_96x128_64x6_2x1_v_bz_NNN", "implicit_gemm"),
    ("gemv2N_kernel<int, int, float, float, float, float, 128, 1, 4, 4>",
     "implicit_gemm"),
    ("cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
     "direct"),
    ("wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>", "direct"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel<float, float>", "other"),
    ("cudnn::engines_precompiled::scalePackedTensor_kernel<float, float>",
     "other")])
def test_conv_algorithm_classes(name, want):
    assert step_profile.conv_algorithm(name) == want


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_roofline_row_on_the_card(dev):
    """One MiDaS shape (the first grouped 3x3) in float32 with TF32 off:
    three timed rows with cuDNN's kernels named, and the timed forward
    equal to the CPU's convolution of the same inputs."""
    import torch.nn.functional as F

    s = next(s for s in roofline.conv_shapes() if s["groups"] == 32)
    with roofline.dtype_mode("float32") as tdtype:
        rows = roofline.measure([s], tdtype, dev, 67.0, reps=3)
        fns = roofline.calls(s, tdtype, dev)
        y = fns["fwd"]().cpu()
    assert [r["dir"] for r in rows] == ["fwd", "dgrad", "wgrad"]
    for r in rows:
        assert r["ms"] > 0 and 0 < r["share"] < 1 and r["kernels"]
    x, wt, bias, _ = (t.cpu() if t is not None else None
                      for t in fns["inputs"])
    ref = F.conv2d(x, wt, bias, s["stride"], s["padding"], s["dilation"],
                   s["groups"])
    assert ((y - ref).abs().max() / ref.abs().max()).item() < 1e-5
