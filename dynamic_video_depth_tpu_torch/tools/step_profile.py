"""Capture and split a device trace of the canonical train step
(counterpart of ``scripts/step_profile.py``).

    python -m dynamic_video_depth_tpu_torch.tools.step_profile \\
        [--iters 3] [--out DIR] [--bf16] \\
        [--depth_net midas|hourglass|dpt_large] [--pairs 1] \\
        [--fused auto|on|off] [--gap 2] [--json]
    python -m dynamic_video_depth_tpu_torch.tools.step_profile \\
        --analyze-only --out DIR      # DIR/trace.json, e.g. a --profile_dir

``capture`` builds the step through ``train/step.py`` on the card with the
DAVIS recipe's hyperparameters (MiDaS fused, 224x384, batch 1, gap 2,
float32 with TF32 off; ``--pairs`` is the batch, ``train_sequence_fast.sh``'s
8 for one; ``--bf16`` is ``--mixed_precision_training``'s
bfloat16 depth compute) on one pair of a synthetic track
(``data/synthetic.py``), with the MiDaS output biased as the fixtures do
(``bias_midas_output``) so that the loss masks are live. After warm-up
steps it traces ``--iters`` main steps with ``torch.profiler`` (CPU and
CUDA activity, ``record_shapes=True``), each step in a ``dvd/step`` span,
into ``DIR/trace.json`` (Chrome trace JSON), and the card's name and power
limit (``nvidia-smi``) into ``DIR/card.txt``. Without a card it raises:
there is no CPU fallback.

``analyze`` reads such a trace, the trainer's ``--profile_dir`` trace too
(its steps carry the same span; it records no shapes). It links each
device event to the CPU op that launched it through the ``correlation``
id of its launch call and the CPU ops that enclose that call in time on
its thread, and reports, per step:

- the step spans on the device (first to last device event launched in a
  ``dvd/step`` span) and the device's busy and idle shares of them;
- device time by category: convolution forward, data gradient and weight
  gradient (by the cuDNN kernel's name: ``fprop``/``dgrad``/``wgrad``; a
  backward kernel that names neither is ``conv bwd``), each split into
  FFT, Winograd, implicit GEMM, direct and other kernels; GEMM; the
  hand-written kernels A-D, the lookup, fused_mlp and the head conv by
  name; the optimizer; elementwise and reduction kernels; memcpy; memset;
  other;
- convolution device time by the shape of its ``aten::convolution`` /
  ``aten::convolution_backward`` op (input, weight, stride, padding,
  groups);
- the top ``--top`` kernels by device time.

The JAX script's ``--dense-group-width``, ``--merge-group-width``,
``--s2d-min-pixels``, ``--merge-reducers`` and ``--wide``'s s2d belong to
TPU workarounds the port leaves out and have no counterpart. A trace
without device events reads "not measured" and exits 1.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

STEP_SPAN = "dvd/step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CPU_CATS = ("cpu_op", "user_annotation")
CARD_FILE = "card.txt"
# the hand-written kernels (csrc/) by the names of their CUDA functions
HAND_KERNELS = {
    "A warp": ("warp_fwd", "warp_bwd"),
    "B mlp_embed": ("mlp_fwd", "mlp_bwd_points"),
    "C chain": ("chain_bwd_points",),
    "D projection loss": ("loss_fwd", "loss_bwd"),
    "lookup": ("corr_lookup",),
    "fused_mlp": ("dense_fwd", "dense_bwd_points"),
    "B/C/fused_mlp tiles (packing, dW)": ("pack_weights", "mlp_dw_partial",
                                          "mlp_dw_reduce"),
    "head conv": ("head_conv_fwd",),
}
CONV_FWD, CONV_BWD = "aten::convolution", "aten::convolution_backward"
# (stride, padding, dilation, groups) among each op's concrete inputs
CONV_ARGS = {CONV_FWD: (3, 4, 5, 8), CONV_BWD: (4, 5, 6, 9)}


class NotMeasured(Exception):
    """The trace holds no device events."""


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ capture


def step_options(depth_net: str, bf16: bool, fused: str):
    """The DAVIS recipe's step hyperparameters (experiments/davis/
    train_sequence.sh) through the train entry's parser."""
    from ..train import cli

    argv = ["--depth_net", depth_net, "--lr", "1e-6", "--scene_lr_mul",
            "1000", "--acc_mul", "1", "--disp_mul", "1", "--flow_mul", "1",
            "--sf_mag_div", "100", "--time_dependent", "--use_disp",
            "--use_pallas_sf_chain", fused, "--use_pallas_loss", fused]
    if depth_net == "midas":
        argv.append("--midas")
    if bf16:
        argv.append("--mixed_precision_training")
    return cli.build_parser().parse_args(argv)


def synthetic_pair(root: str, gap: int, h: int, w: int, device,
                   pairs: int = 1):
    """The first ``pairs`` training pairs at ``gap`` of a synthetic track,
    as one batch on ``device``."""
    from ..data.batches import collate_batches, to_device
    from ..data.davis_sequence import Dataset
    from ..data.synthetic import make_track

    make_track(root, track="profile", n_frames=gap + pairs + 1, h=h, w=w,
               gaps=(gap,))
    ds = Dataset(argparse.Namespace(track_id="profile", gaps=str(gap),
                                    subsample=False, data_root=root),
                 mode="train")
    return to_device(collate_batches([ds[i] for i in range(pairs)]),
                     device)


def capture(outdir: str, iters: int = 3, depth_net: str = "midas",
            bf16: bool = False, fused: str = "auto", gap: int = 2,
            h: int = 224, w: int = 384, warmup: int = 3,
            pairs: int = 1) -> str:
    """Trace ``iters`` main steps on the card into ``outdir/trace.json``;
    returns its path."""
    import torch

    from ..runtime import profiling
    from ..runtime.weights import bias_midas_output
    from ..train.scene_flow_motion_field import step_config
    from ..train.step import SceneFlowMotionFieldStep

    if not torch.cuda.is_available():
        raise RuntimeError("step_profile.capture traces the card and no CUDA "
                           "device is available; there is no CPU fallback")
    dev = torch.device("cuda", 0)
    step = SceneFlowMotionFieldStep(
        step_config(step_options(depth_net, bf16, fused)), device=dev)
    if depth_net != "hourglass":
        bias_midas_output(step.net_depth)
    with tempfile.TemporaryDirectory() as root:
        batch = synthetic_pair(root, gap, h, w, dev, pairs)
    for _ in range(warmup):
        step.train_step(batch, steps=gap, warm=False)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for _ in range(iters):
            with profiling.annotate(STEP_SPAN):
                step.train_step(batch, steps=gap, warm=False)
        torch.cuda.synchronize()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, profiling.TRACE_NAME)
    prof.export_chrome_trace(path)
    with open(os.path.join(outdir, CARD_FILE), "w") as f:
        f.write(card_line() + "\n")
    return path


# ------------------------------------------------------------------ analyze


def load_trace(outdir: str):
    """The events of ``outdir/trace.json`` and the card that wrote it:
    ``card.txt`` beside it, else the trace's device name."""
    from ..runtime.profiling import TRACE_NAME

    path = os.path.join(outdir, TRACE_NAME)
    with open(path) as f:
        trace = json.load(f)
    card_path = os.path.join(outdir, CARD_FILE)
    if os.path.isfile(card_path):
        with open(card_path) as f:
            card = f.read().strip()
    else:
        names = [p.get("name", "?") for p in trace.get("deviceProperties")
                 or []]
        card = (names[0] if names else "card not recorded") + \
            ", power limit not recorded"
    return trace["traceEvents"], card, path


class Links:
    """Each device event's launch call and the CPU ops around it."""

    def __init__(self, events: List[dict]):
        self.launch = {}   # correlation id -> launch event
        self.parent = {}   # id(event) -> enclosing CPU event
        by_thread = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = e
            if cat in LAUNCH_CATS or cat in CPU_CATS:
                by_thread[(e.get("pid"), e.get("tid"))].append(e)
        for evs in by_thread.values():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
            stack = []
            for e in evs:
                end = float(e["ts"]) + float(e.get("dur", 0))
                while stack and float(stack[-1]["ts"]) + float(
                        stack[-1].get("dur", 0)) < end:
                    stack.pop()
                if stack:
                    self.parent[id(e)] = stack[-1]
                stack.append(e)

    def launched_by(self, dev_event: dict) -> Optional[dict]:
        return self.launch.get(dev_event.get("args", {}).get("correlation"))

    def ancestors(self, dev_event: dict) -> List[dict]:
        """The CPU ops and spans around the event's launch, innermost
        first."""
        out, e = [], self.launched_by(dev_event)
        while e is not None:
            e = self.parent.get(id(e))
            if e is not None:
                out.append(e)
        return out


# cuDNN's kernels by the algorithm their names give away (names read on
# an H100 with cuDNN 9); layout transposes, scalings and memsets are other
ALGORITHM_WORDS = (
    ("fft", ("fft", "cf32", "region_transform")),
    ("winograd", ("winograd",)),
    ("implicit_gemm", ("implicit", "xmma", "convolve", "gemm", "gemv",
                       "tensorop", "nvjet")),
    ("direct", ("direct", "dgrad_engine", "wgrad_alg", "wgrad2d_shmem")),
)


def conv_algorithm(name: str) -> str:
    n = name.lower()
    for algorithm, words in ALGORITHM_WORDS:
        if any(w in n for w in words):
            return algorithm
    return "other"


def conv_direction(name: str, op: str) -> str:
    n = name.lower()
    if "dgrad" in n:
        return "conv dgrad"
    if "wgrad" in n:
        return "conv wgrad"
    return "conv fwd" if op == CONV_FWD else "conv bwd"


def conv_shape(op: dict) -> str:
    """``x[N,C,H,W] w[O,I,kh,kw] s.. p.. d.. g..`` of a convolution op
    (the shapes need ``record_shapes``)."""
    args = op.get("args", {})
    dims = args.get("Input Dims")
    if not dims:
        return "shape not recorded"
    x, wt = (dims[0], dims[1]) if op["name"] == CONV_FWD else \
        (dims[1], dims[2])
    concrete = args.get("Concrete Inputs") or []
    s, p, d, g = (concrete[i] if i < len(concrete) else "?"
                  for i in CONV_ARGS[op["name"]])
    squash = lambda v: str(v).replace(" ", "")  # noqa: E731
    return (f"x{squash(x)} w{squash(wt)} s{squash(s)} p{squash(p)} "
            f"d{squash(d)} g{g}")


def kernel_name(name: str) -> str:
    return (name.replace("(anonymous namespace)::", "").replace("void ", "")
            .split("(")[0])


def classify(e: dict, links: Links):
    """(category, convolution shape or None) of a device event."""
    cat = e.get("cat")
    if cat == "gpu_memcpy":
        return "memcpy", None
    if cat == "gpu_memset":
        return "memset", None
    name = kernel_name(e.get("name", ""))
    base = name.split("<")[0].split("::")[-1]
    for label, fns in HAND_KERNELS.items():
        if base in fns:
            return label, None
    ancestors = links.ancestors(e)
    for op in ancestors:
        if op.get("name") in CONV_ARGS:
            return (f"{conv_direction(name, op['name'])}, "
                    f"{conv_algorithm(name)}", conv_shape(op))
    low = name.lower()
    if any(a.get("name", "").startswith("Optimizer.") for a in ancestors) \
            or "multi_tensor_apply" in low or "adam" in low:
        return "optimizer", None
    if "gemm" in low or "cutlass" in low or "cublas" in low:
        return "gemm", None
    if "reduce" in low or "elementwise" in low or "at::native" in low:
        return "elementwise/reduction", None
    return "other", None


def busy_us(intervals) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def analyze(events: List[dict], card: str, top: int = 15) -> Dict:
    """Split the device time of ``events``, per step (raises
    ``NotMeasured`` when there are no device events)."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    if not device:
        raise NotMeasured("the trace holds no device events")
    links = Links(events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("name") == STEP_SPAN
                   and e.get("cat") == "user_annotation")
    starts = [a for a, _ in spans]
    steps = collections.defaultdict(list)  # step index -> device events
    for e in device:
        if not spans:
            steps[0].append(e)
            continue
        launch = links.launched_by(e)
        if launch is None:
            continue
        t = float(launch["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            steps[i].append(e)
    if not steps:
        raise NotMeasured("no device event was launched inside a "
                          f"{STEP_SPAN} span")
    n = len(steps)
    step_spans, busy = [], 0.0
    per_cat = collections.defaultdict(lambda: [0, 0.0])
    conv_shapes = collections.defaultdict(
        lambda: collections.defaultdict(float))
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for evs in steps.values():
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
               for e in evs]
        step_spans.append((max(b for _, b in ivs) - min(a for a, _ in ivs))
                          / 1e3)
        busy += busy_us(ivs)
        for e in evs:
            d = float(e.get("dur", 0))
            label, shape = classify(e, links)
            per_cat[label][0] += 1
            per_cat[label][1] += d
            if shape is not None:
                conv_shapes[shape][label.split(",")[0]] += d
            nm = by_name[kernel_name(e.get("name", ""))]
            nm[0] += 1
            nm[1] += d
    span_total = sum(step_spans) * 1e3
    conv_rows = sorted(({"shape": s, "ms": sum(v.values()) / n / 1e3,
                         **{k: ms / n / 1e3 for k, ms in v.items()}}
                        for s, v in conv_shapes.items()),
                       key=lambda r: -r["ms"])
    conv_ms = sum(ms for k, (_, ms) in per_cat.items()
                  if k.startswith("conv")) / n / 1e3
    return {
        "card": card,
        "n_steps": n,
        "step_spans_ms": step_spans,
        "busy_ms": busy / n / 1e3,
        "busy_share": busy / span_total if span_total else 0.0,
        "idle_share": 1.0 - busy / span_total if span_total else 0.0,
        "device_ms": sum(ms for _, ms in per_cat.values()) / n / 1e3,
        "conv_ms": conv_ms,
        "by_category": {k: {"n": c / n, "ms": ms / n / 1e3} for k, (c, ms)
                        in sorted(per_cat.items(), key=lambda kv: -kv[1][1])},
        "conv_by_shape": conv_rows,
        "top_kernels": [{"name": nm[:100], "n": c / n, "ms": ms / n / 1e3}
                        for nm, (c, ms) in sorted(
                            by_name.items(), key=lambda kv: -kv[1][1])[:top]],
    }


def report(r: Dict, top: int = 15) -> None:
    print(f"card: {r['card']}")
    spans = ", ".join(f"{s:.3f}" for s in r["step_spans_ms"])
    print(f"steps: {r['n_steps']}, device spans [{spans}] ms "
          f"(median {statistics.median(r['step_spans_ms']):.3f})")
    print(f"per step: device busy {r['busy_ms']:.3f} ms, busy share "
          f"{r['busy_share']:.4f}, idle share {r['idle_share']:.4f}, "
          f"convolutions {r['conv_ms']:.3f} ms")
    print("device time by category (per step):")
    for k, v in r["by_category"].items():
        print(f"  {k:<36} n={v['n']:<7g} {v['ms']:9.3f} ms")
    print("convolution device time by shape (per step):")
    for row in r["conv_by_shape"][:top]:
        split = ", ".join(f"{k} {v:.3f}" for k, v in row.items()
                          if k.startswith("conv"))
        print(f"  {row['ms']:9.3f} ms  {row['shape']}  ({split})")
    print("top kernels by device time (per step):")
    for t in r["top_kernels"]:
        print(f"  {t['ms']:9.3f} ms n={t['n']:<5g} {t['name']}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.tools.step_profile")
    ap.add_argument("--out", default="./step_profile",
                    help="the trace's directory (trace.json, card.txt)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--gap", type=int, default=2,
                    help="the frame gap (Euler steps) of the traced pair")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 depth compute "
                    "(--mixed_precision_training)")
    ap.add_argument("--depth_net", default="midas",
                    choices=("midas", "hourglass", "dpt_large"))
    ap.add_argument("--pairs", type=int, default=1,
                    help="pairs a batch (the recipe's 1)")
    ap.add_argument("--fused", default="auto", choices=("auto", "on", "off"),
                    help="the fused chain and loss (--use_pallas_sf_chain, "
                    "--use_pallas_loss)")
    ap.add_argument("--analyze-only", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of the text report")
    ap.add_argument("--top", type=int, default=15)
    a = ap.parse_args(argv)
    if not a.analyze_only:
        path = capture(a.out, a.iters, a.depth_net, a.bf16, a.fused, a.gap,
                       pairs=a.pairs)
        print(f"trace written to {path}")
    events, card, path = load_trace(a.out)
    try:
        result = analyze(events, card, a.top)
    except NotMeasured as e:
        print(f"{path}: device time not measured ({e})")
        return 1
    if a.json:
        print(json.dumps(result))
    else:
        print(f"analyzing {path}")
        report(result, a.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
