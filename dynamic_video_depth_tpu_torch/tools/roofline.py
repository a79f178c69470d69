"""Every convolution shape of the MiDaS step, timed on the card against
the peak of its type (counterpart of ``scripts/roofline.py``).

    python -m dynamic_video_depth_tpu_torch.tools.roofline \\
        [--dtype float32|tf32|bfloat16] [--h 224 --w 384 --frames 2] \\
        [--reps 20] [--top 10] [--json]

The JAX script timed a hand-written list of shapes, which drifted from the
net; here the shapes come from the net itself. ``conv_shapes`` runs the
port's ``MidasNet`` on the ``meta`` device (shapes only, no arithmetic)
with a forward hook on every ``nn.Conv2d`` and counts each shape (input,
output, kernel, stride, padding, dilation, groups, bias, and whether its
input takes a gradient: the stem's, made from the image, does not, and
the step computes no dgrad there) per forward of ``--frames`` frames at
``--h`` x ``--w``. ``conv_flops`` is
``2 * N * Ho * Wo * Cout * Cin/groups * kh * kw`` a call (the bias is not
counted, as ``torch.utils.flop_counter`` does not count it).

``run`` (card only; it raises without one) times each shape forward,
input gradient and weight gradient (``aten.convolution_backward`` with one
output of the mask, as autograd calls it) with CUDA events around
``--reps`` launches after a warm-up, in ``--dtype``: ``float32`` with TF32
off (the step's setting, ``train/step.py``), ``tf32`` (float32 tensors,
cuDNN's TF32 on) or ``bfloat16``. One profile of all of them names the
cuDNN kernels each launches and their class (FFT, Winograd, implicit GEMM,
direct, other: ``step_profile.conv_algorithm``). Each row gives the
achieved TFLOP/s and its share of the card's dense peak for the type (H100
SXM: 67 TFLOP/s float32 FMA, 495 TF32, 989 bf16; the card's name and
power limit beside it), and ms x count a forward. The rate counts the
direct convolution's operations, so an algorithm that does fewer
(Winograd) can show a share above 1. The sums over the rows
are the step's convolution time as separate calls would take it; the
step's own convolution time is ``step_profile``'s (cuDNN may choose
another algorithm inside the step than for a call alone). Two cap probes
as in the JAX script: a 4096^3 matmul and a dense 3x3x512 convolution at
56x96, in the same type.

Measurement only: nothing here changes the step (no pinned algorithm, no
TF32 in the step).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence

from .step_profile import Links, card_line, conv_algorithm, kernel_name

DTYPES = ("float32", "tf32", "bfloat16")
# dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet), TFLOP/s
PEAK_TFLOPS = {"float32": 67.0, "tf32": 495.0, "bfloat16": 989.0}
DIRECTIONS = ("fwd", "dgrad", "wgrad")
SPAN = "roofline/"  # the profiler span of one timed call's launches


def conv_shapes(h: int = 224, w: int = 384, frames: int = 2) -> List[Dict]:
    """The convolutions of one MiDaS forward of ``frames`` frames at
    ``h x w``: one dict a distinct shape with its ``count``, in order of
    first call."""
    import torch

    from ..models import MidasNet

    net = MidasNet(generator=torch.Generator().manual_seed(0)).to("meta")
    counts = collections.Counter()

    def hook(m, inputs, out):
        counts[(tuple(inputs[0].shape), tuple(out.shape), m.kernel_size,
                m.stride, m.padding, m.dilation, m.groups,
                m.bias is not None, inputs[0].requires_grad)] += 1

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        # with gradients on, as in the step: an input that needs no
        # gradient (the stem's, made from the image) takes no dgrad
        with torch.enable_grad():
            net(torch.empty(frames, h, w, 3, device="meta"))
    finally:
        for handle in handles:
            handle.remove()
    keys = ("input", "output", "kernel", "stride", "padding", "dilation",
            "groups", "bias", "dgrad")
    return [dict(zip(keys, k), count=n) for k, n in counts.items()]


def conv_flops(s: Dict) -> int:
    n, cout, ho, wo = s["output"]
    kh, kw = s["kernel"]
    return 2 * n * ho * wo * cout * (s["input"][1] // s["groups"]) * kh * kw


def label(s: Dict) -> str:
    n, c, h, w = s["input"]
    kh, kw = s["kernel"]
    return (f"{kh}x{kw}/{s['stride'][0]} g{s['groups']} {c}->"
            f"{s['output'][1]} @{h}x{w}" + (" +bias" if s["bias"] else ""))


@contextlib.contextmanager
def dtype_mode(dtype: str):
    """The tensors' type and cuDNN's TF32 switch for ``dtype``; restored
    on the way out."""
    import torch

    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    tf32 = dtype == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield torch.bfloat16 if dtype == "bfloat16" else torch.float32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def calls(s: Dict, tdtype, dev, seed: int = 0) -> Dict:
    """The three calls of shape ``s`` on ``dev``, as autograd makes them,
    and their ``inputs`` (x, weight, bias, output cotangent)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    cin, groups = s["input"][1], s["groups"]
    x = torch.randn(s["input"], generator=gen, device=dev, dtype=tdtype)
    wt = torch.randn((s["output"][1], cin // groups) + tuple(s["kernel"]),
                     generator=gen, device=dev, dtype=tdtype) * 0.05
    bias = torch.zeros(s["output"][1], device=dev, dtype=tdtype) \
        if s["bias"] else None
    gy = torch.randn(s["output"], generator=gen, device=dev, dtype=tdtype)
    geom = (list(s["stride"]), list(s["padding"]), list(s["dilation"]))
    bias_sizes = [s["output"][1]] if s["bias"] else None

    def bwd(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gy, x, wt, bias_sizes, *geom, False, [0, 0], groups, mask)

    return {"fwd": lambda: F.conv2d(x, wt, bias, *geom, groups),
            "dgrad": bwd([True, False, False]),
            "wgrad": bwd([False, True, False]),
            "inputs": (x, wt, bias, gy)}


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device ms a call: CUDA events around ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def name_kernels(fns, calls: int = 3) -> List[List[str]]:
    """The names of the device kernels that each of ``fns`` launches, in
    order of first launch: one profile (CPU and CUDA activity) of
    ``calls`` calls of each, each function's calls in a span of their own,
    read from the exported Chrome trace and linked to the spans as
    ``step_profile`` links kernels to ops. One long profile: short ones,
    late in a process that profiled before, recorded no kernel for some
    calls, and ``key_averages`` drops the cuBLAS kernels that cuDNN runs
    some 1x1 convolutions with."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i, fn in enumerate(fns):
            with torch.profiler.record_function(f"{SPAN}{i}"):
                for _ in range(calls):
                    fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return span_kernels(json.load(f)["traceEvents"], len(fns))


def span_kernels(events: List[dict], n: int) -> List[List[str]]:
    """The kernel names launched inside each span ``roofline/<i>``,
    ``i < n``, of a trace's events."""
    links, names = Links(events), [[] for _ in range(n)]
    for e in sorted((e for e in events if e.get("cat") == "kernel"),
                    key=lambda e: float(e["ts"])):
        for op in links.ancestors(e):
            if op.get("name", "").startswith(SPAN):
                names[int(op["name"][len(SPAN):])].append(
                    kernel_name(e.get("name", "")))
                break
    return [list(dict.fromkeys(k)) for k in names]


def algorithm_class(names: List[str]) -> str:
    """The row's algorithm: its kernels' first class in the order FFT,
    Winograd, implicit GEMM, direct (the others are the layout and scaling
    helpers around them)."""
    if not names:
        return "not recorded"
    classes = [conv_algorithm(n) for n in names]
    for c in ("fft", "winograd", "implicit_gemm", "direct"):
        if c in classes:
            return c
    return "other"


def cap_probes(tdtype, dev, reps: int) -> Dict:
    """TFLOP/s of a 4096^3 matmul and of a dense 3x3 512->512 convolution
    at 56x96 on two frames, in the type of the run."""
    import torch

    n = 4096
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(n, n, generator=gen, device=dev, dtype=tdtype)
    b = torch.randn(n, n, generator=gen, device=dev, dtype=tdtype)
    mm = time_ms(lambda: a @ b, reps)
    dense = {"input": (2, 512, 56, 96), "output": (2, 512, 56, 96),
             "kernel": (3, 3), "stride": (1, 1), "padding": (1, 1),
             "dilation": (1, 1), "groups": 1, "bias": False}
    conv = time_ms(calls(dense, tdtype, dev)["fwd"], reps)
    return {"matmul_tflops": 2.0 * n ** 3 / mm / 1e9,
            "conv_tflops": conv_flops(dense) / conv / 1e9}


def measure(shapes: List[Dict], tdtype, dev, peak: float,
            reps: int) -> List[Dict]:
    """The rows of ``shapes``: each shape's forward, dgrad (where the step
    takes it) and wgrad, timed, then their kernels named."""
    rows, fns = [], []
    for s in shapes:
        flops, calls_s = conv_flops(s), calls(s, tdtype, dev)
        for d in DIRECTIONS if s["dgrad"] else ("fwd", "wgrad"):
            ms = time_ms(calls_s[d], reps)
            tflops = flops / ms / 1e9
            rows.append({"shape": label(s), "dir": d, "count": s["count"],
                         "flops": flops, "ms": ms, "tflops": tflops,
                         "share": tflops / peak,
                         "ms_x_count": ms * s["count"]})
            fns.append(calls_s[d])
    for row, names in zip(rows, name_kernels(fns)):
        row.update(algorithm=algorithm_class(names), kernels=names)
    return rows


def run(dtype: str = "float32", h: int = 224, w: int = 384,
        frames: int = 2, reps: int = 20) -> Dict:
    """Time every convolution shape of the MiDaS forward on the card."""
    import torch

    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {DTYPES}")
    if not torch.cuda.is_available():
        raise RuntimeError("roofline times the card and no CUDA device is "
                           "available; there is no CPU fallback")
    dev = torch.device("cuda", 0)
    peak = PEAK_TFLOPS[dtype]
    with dtype_mode(dtype) as tdtype:
        caps = cap_probes(tdtype, dev, reps)
        rows = measure(conv_shapes(h, w, frames), tdtype, dev, peak, reps)
    sums = {d: sum(r["ms_x_count"] for r in rows if r["dir"] == d)
            for d in DIRECTIONS}
    return {"card": card_line(), "dtype": dtype, "peak_tflops": peak,
            "h": h, "w": w, "frames": frames, "reps": reps,
            "n_convs": sum(r["count"] for r in rows if r["dir"] == "fwd"),
            "n_shapes": sum(r["dir"] == "fwd" for r in rows),
            "gflop_fwd": sum(r["flops"] * r["count"] for r in rows
                             if r["dir"] == "fwd") / 1e9,
            "caps": caps, "sum_ms": sums,
            "sum_step_ms": sum(sums.values()), "rows": rows}


def top_shapes(result: Dict, n: int = 10) -> List[Dict]:
    """The ``n`` shapes with the most time x count over the three
    directions."""
    by = collections.defaultdict(list)
    for r in result["rows"]:
        by[r["shape"]].append(r)
    return sorted(by.values(),
                  key=lambda rs: -sum(r["ms_x_count"] for r in rs))[:n]


def report(r: Dict, top: int = 10) -> None:
    c = r["caps"]
    print(f"card: {r['card']}; dtype {r['dtype']} (peak "
          f"{r['peak_tflops']:g} TFLOP/s dense)")
    print(f"MidasNet {r['frames']} x {r['h']}x{r['w']}: {r['n_convs']} "
          f"convolutions of {r['n_shapes']} shapes, {r['gflop_fwd']:.1f} "
          f"GFLOP a forward")
    print(f"caps: 4096^3 matmul {c['matmul_tflops']:.2f} TFLOP/s, dense "
          f"3x3x512 conv @56x96 {c['conv_tflops']:.2f} TFLOP/s")
    print("| shape (x count a forward) | dir | algorithm | ms | TFLOP/s | "
          "share of peak | ms x count |")
    print("|---|---|---|---|---|---|---|")
    for rs in top_shapes(r, top):
        for x in rs:
            print(f"| {x['shape']} x{x['count']} | {x['dir']} | "
                  f"{x['algorithm']} | {x['ms']:.4f} | {x['tflops']:.2f} | "
                  f"{x['share']:.4f} | {x['ms_x_count']:.3f} |")
    s = r["sum_ms"]
    print(f"sum over all shapes x count: fwd {s['fwd']:.3f} ms, dgrad "
          f"{s['dgrad']:.3f} ms, wgrad {s['wgrad']:.3f} ms, a step's "
          f"{r['sum_step_ms']:.3f} ms")
    algo = collections.defaultdict(float)
    for x in r["rows"]:
        algo[x["algorithm"]] += x["ms_x_count"]
    print("by algorithm: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                        sorted(algo.items(),
                                               key=lambda kv: -kv[1])))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.tools.roofline")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--h", type=int, default=224)
    ap.add_argument("--w", type=int, default=384)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames through the net (2 x the pair batch)")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches timed per shape and direction")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    result = run(a.dtype, a.h, a.w, a.frames, a.reps)
    if a.json:
        print(json.dumps(result))
    else:
        report(result, a.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
