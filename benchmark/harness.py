"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``) and the correctness check.

Set-up writes the cell's track into a fresh directory under ``TMPDIR``,
makes the weights on the device from the seed, builds the trainer through
the port's train entry (``train.cli.build_run`` with the recipe's flags),
loads the weights into its nets and drives it through one round of its
epoch order, one batch of every gap (``Trainer.train_epoch``): that round
warms every shape, cuDNN's choices and the kernels' variants, fills the
trainer's ``DeviceCache``, and gives the readings that the reference is
compared with. The window is then one epoch of a fixed number of whole
rounds, ``round(--seconds / round_seconds)`` of the traffic file, every
round visiting every batch once, in the sequence that the traffic's
``order_seed`` draws: every seed does the same work in the same order. It runs from the first step's launch to the end of the last, ended by
a synchronise. With ``--trace 1`` one more round runs under
``torch.profiler`` after the window, with spans around the calls into the
depth net and the field. After that the program is freed and the plain
reference follows the set-up round on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from . import check, spec, trace, track, workcount
from . import weights as wmod
from .reference.step import ReferenceStep, follow, load_batch

FORBIDDEN = ("jax", "jaxlib", "flax", "dynamic_video_depth_tpu")
LAYER_SPANS = {"bench/depth_net": "depth_net", "bench/field": "field"}
TRACK = "bench"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def recipe_argv(cell: spec.Cell, data_root: str, logdir: str,
                device: str) -> List[str]:
    """The train entry's flags: the traffic's recipe and the
    configuration's net; no visualization, saves or validation (the
    window drives ``train_epoch`` alone). The trainer's own seed, which
    draws its batches and their order, is the traffic's ``order_seed``
    whatever the run's seed: the order of the gaps moves the rate where
    the host paces part of a step, so every seed gets the same
    sequence of rounds and only its own weights and track."""
    tr, rec = cell.traffic, cell.traffic["recipe"]
    argv = ["--net", "scene_flow_motion_field", "--dataset",
            "davis_sequence", "--track_id", TRACK, "--data_root", data_root,
            "--logdir", logdir, "--device", device,
            "--manual_seed", str(tr["order_seed"]),
            "--epoch", str(rec["warm_sf"] + 3),
            "--batch_size", str(tr["batch_size"]),
            "--gaps", ",".join(str(g) for g in tr["gaps"]),
            "--optim", rec["optim"], "--log_time",
            "--vis_every_train", "0", "--vis_every_vali", "0",
            "--save_net", "0"]
    for key in ("lr", "scene_lr_mul", "adam_beta1", "adam_beta2", "warm_sf",
                "acc_mul", "disp_mul", "flow_mul", "sf_mag_div"):
        argv += [f"--{key}", repr(rec[key])]
    argv += [f for f, on in (("--time_dependent", rec["time_dependent"]),
                             ("--use_disp", rec["use_disp"]),
                             ("--mixed_precision_training",
                              tr["precision"] == "bfloat16")) if on]
    return argv + list(cell.config["program_flags"])


def span(obj, attr: str, name: str) -> None:
    """Wrap ``obj.attr`` (an instance attribute from now on) in a named
    profiler span."""
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    setattr(obj, attr, wrapped)


class Program:
    """The port on one cell: its track, weights and trainer."""

    def __init__(self, cell: spec.Cell, seed: int, device: str,
                 workdir: str, hw: Optional[tuple] = None):
        from dynamic_video_depth_tpu_torch.train import cli

        tr = cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.hw = hw or (tr["height"], tr["width"])
        self.data_root = os.path.join(workdir, "data")
        # set-up's parts in seconds, for the run's report
        self.phases, t = {}, time.perf_counter()
        self.n_frames = track.make_track(
            self.data_root, TRACK, *self.hw, tr["gaps"],
            tr["batches_per_gap"] * tr["batch_size"], seed)
        t = self._phase("track", t)
        with torch.device("meta"):
            layout = cell.build_reference(cell.config)
        weights = wmod.make_weights(cell.config, layout, seed, self.device)
        self.initial = {k: v.to("cpu", copy=True) for k, v in weights.items()}
        t = self._phase("weights", t)
        self.run = cli.build_run(recipe_argv(
            cell, self.data_root, os.path.join(workdir, "run"), device))
        self.trainer = self.run.trainer
        step = self.trainer.step
        t = self._phase("build_run", t)
        step.net_depth.load_state_dict(wmod.split(weights, "depth."))
        step.net_sf.load_state_dict(wmod.split(weights, "field."))
        self._weights = weights
        self.names = {}
        for prefix, net in (("depth.", step.net_depth),
                            ("field.", step.net_sf)):
            for n, p in net.named_parameters():
                self.names[id(p)] = prefix + n
        self.epoch_no = tr["recipe"]["warm_sf"]
        opt = self.trainer.opt
        self.trainer.logger.set_params({"epochs": opt.epoch,
                                        "steps": len(self.trainer.groups)})
        self.trainer.logger.on_train_begin()

    def _phase(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.phases[name] = t - t0
        return t

    @property
    def batch_size(self) -> int:
        return self.cell.traffic["batch_size"]

    def epoch(self, rounds: int) -> List[dict]:
        """One main epoch of ``rounds`` whole rounds; its step records."""
        self.epoch_no += 1
        trainer = self.trainer
        trainer.opt.epoch_batches = len(trainer.groups) * rounds
        trainer.logger.on_epoch_begin(self.epoch_no)
        start = len(trainer.history)
        trainer.train_epoch(self.epoch_no)
        return trainer.history[start:]

    def setup_round(self) -> dict:
        """The first round, recorded: each step's gap and pairs and loss,
        the first gradient's leaf norms as Adam got it, and the leaves'
        change after ``check.CHANGE_AFTER`` steps, before the next step
        moves them."""
        step = self.trainer.step
        beta1 = self.cell.traffic["recipe"]["adam_beta1"]
        seen, first, change = [], {}, {}

        def recorded(batch, steps, warm, reduce=None):
            logs = original(batch, steps, warm, reduce)
            seen.append((int(steps), [int(round(f)) for f in
                                      batch["frame_id_1"].tolist()],
                         bool(warm)))
            if len(seen) == check.CHANGE_AFTER:
                change.update(self._change_norms())
            if len(seen) == 1:
                norms = {}
                for opt in step.optimizers:
                    for group in opt.param_groups:
                        for p in group["params"]:
                            m = opt.state.get(p, {}).get("exp_avg")
                            norms[self.names[id(p)]] = (
                                torch.linalg.vector_norm(m.double())
                                / (1.0 - beta1) if m is not None
                                else torch.zeros((), dtype=torch.float64))
                first.update(zip(norms, torch.stack(
                    [v.to(self.device) for v in norms.values()]).tolist()))
            return logs

        original = step.train_step
        step.train_step = recorded
        t = time.perf_counter()
        try:
            records = self.epoch(1)
        finally:
            del step.train_step
        self._phase("setup_round", t)
        self._weights = None
        if any(w for _, _, w in seen):
            raise RuntimeError("a set-up step ran as a warm-up step")
        return {"losses": [r["loss"] + r["acc_reg"] for r in records],
                "first": first, "change": change,
                "steps": [(g, f) for g, f, _ in seen]}

    def _change_norms(self) -> Dict[str, float]:
        """Each leaf's change from the initial weights, by norm."""
        step, norms = self.trainer.step, {}
        for prefix, net in (("depth.", step.net_depth),
                            ("field.", step.net_sf)):
            for n, p in net.named_parameters():
                norms[prefix + n] = torch.linalg.vector_norm(
                    p.detach().double() - self._weights[prefix + n].double())
        return dict(zip(norms, torch.stack(list(norms.values())).tolist()))

    def close(self) -> None:
        """End the trainer's threads and free what the program holds."""
        if self.run is None:
            return
        try:
            self.trainer.logger.on_train_end()
        finally:
            self.run = self.trainer = None
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


def reference_readings(cell: spec.Cell, program: Program, steps, device,
                       precision: Optional[str] = None,
                       fault: Optional[str] = None) -> dict:
    """The plain reference over the set-up round's steps, from the same
    weights and pairs."""
    with torch.device(device):
        net = cell.build_reference(cell.config)
    ref = ReferenceStep(net, program.initial, cell.config, cell.traffic,
                        device, precision or cell.traffic["precision"],
                        fault)
    try:
        batches = [(gap, load_batch(program.data_root, TRACK, gap, firsts,
                                    program.n_frames, device))
                   for gap, firsts in steps]
        losses, first, change = follow(ref, batches, program.initial,
                                       check.CHANGE_AFTER)
    finally:
        ref.close()
    return {"losses": losses, "first": first, "change": change}


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read."""

    records: List[dict]        # the window's step records (trainer.history)
    window_s: float
    precision: str             # the depth net's
    depth_work: Dict[str, float]   # a main step's, forward and backward
    field_work: Callable[[int], Dict[str, float]]   # by gap
    trace: Optional[dict]      # trace.analyze's, with the traced gaps

    def step_least_seconds(self, gap: int) -> float:
        """A main step's model FLOPs at the peaks of their types."""
        return (self.depth_work["flops"]
                / workcount.PEAK_FLOPS[self.precision]
                + self.field_work(gap)["flops"]
                / workcount.PEAK_FLOPS["float32"])


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "power limit not read"


def traced_round(program: Program, workdir: str) -> dict:
    """One more round under ``torch.profiler``, with spans around the
    depth net's forward and the field's evaluations."""
    step = program.trainer.step
    span(step.net_depth, "forward", "bench/depth_net")
    span(step.net_sf, "forward", "bench/field")
    span(step.net_sf, "chain", "bench/field")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        records = program.epoch(1)
        torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    analysis = trace.analyze(events, LAYER_SPANS)
    if analysis:
        analysis["gaps"] = [r["gap"] for r in records]
    return analysis


def run(workload: str, seed: int, seconds: float, traced: bool,
        started: float) -> int:
    cell = spec.load_cell(workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no run: {workload} needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="dvd-bench-")
    try:
        return _run(cell, seed, seconds, traced, started, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, traced, started, workdir, device="cuda",
         hw=None) -> int:
    tr = cell.traffic
    t_import = time.perf_counter()
    program = Program(cell, seed, device, workdir, hw)
    readings = program.setup_round()
    phases = dict(start=t_import - started, **program.phases)
    rounds = max(1, round(seconds / tr["round_seconds"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - started
    records = program.epoch(rounds)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    analysis = traced_round(program, workdir) if traced else None
    found = forbidden_modules()
    if found:
        print(f"no result: modules {found} are loaded", file=sys.stderr)
        return 3
    program.close()

    ref = reference_readings(cell, program, readings["steps"], device)
    nums = check.numbers(readings, ref)
    correct = check.verdict(nums, cell.limits)

    steps = len(records)
    n = steps // rounds  # steps a round
    pairs = steps * program.batch_size
    failed = sum(1 for r in records if not math.isfinite(r["loss"]))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    card = card_line()
    lines = [f"card: {card}",
             f"window: {rounds} rounds, {steps} steps, {pairs} pairs in "
             f"{window_s!r} s; set-up {setup_s!r} s: "
             + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
             "window steps: device span "
             f"{statistics.mean(r['seconds'] for r in records)!r} s, "
             f"interval {statistics.mean(r['interval'] for r in records)!r}"
             f" s, data wait {statistics.mean(r['data_time'] for r in records)!r} s",
             "rounds' device-clock seconds: " + " ".join(
                 f"{sum(r['interval'] for r in records[i:i + n]):.4f}"
                 for i in range(0, steps, n)),
             f"reference losses {ref['losses']!r}",
             f"program losses {readings['losses']!r}",
             f"worst leaves: gradient {nums['grad_leaf']}, change "
             f"{nums['change_leaf']}; {nums['still_leaves']} leaves "
             "left out as unmoved"]
    if traced:
        record = RunRecord(
            records=records, window_s=window_s, precision=tr["precision"],
            depth_work=depth_work(cell, program.hw),
            field_work=lambda gap: workcount.field_work(
                cell.config["field"], program.batch_size * program.hw[0]
                * program.hw[1], gap),
            trace=analysis or None)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if analysis:
            device_info["busy_s"] = analysis["busy_s"]
            device_info["window_s"] = analysis["window_s"]
            lines += [
                "peaks: 989 TFLOP/s bfloat16, 495 TFLOP/s float32 operands "
                "(TF32 tensor cores), 3.35 TB/s (H100 SXM data sheet, "
                f"dense); card and power limit: {card}",
                f"device seconds by layer over {len(analysis['gaps'])} "
                f"traced steps (gaps {analysis['gaps']}): "
                f"{analysis['layer_s']!r}",
                f"device events {analysis['device_events']}, unlinked "
                f"{analysis['unlinked']}, launches {analysis['launches']}"]
    else:
        values = {"pairs_per_s": pairs / window_s, "peak_gib": peak / 2 ** 30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if analysis:
        result["breakdown"] = {"device_ops": analysis["device_ops"],
                               "idle_gaps": analysis["idle_gaps"]}
    result["check"] = {k: {"value": nums[k] if math.isfinite(nums[k])
                           else str(nums[k]), "limit": cell.limits[k]}
                       for k in check.NUMBERS}
    for line in lines + check.report(nums, cell.limits):
        print(line, file=sys.stderr, flush=True)
    # a line of its own: the program's progress bar leaves one open
    print("\n" + json.dumps(result), flush=True)
    return 0


def depth_work(cell: spec.Cell, hw) -> Dict[str, float]:
    """A main step's depth-net convolutions over both frames of each
    pair."""
    with torch.device("meta"):
        net = cell.build_reference(cell.config)
    calls = workcount.conv_shapes(net, 2 * cell.traffic["batch_size"], *hw)
    return workcount.conv_work(calls, cell.traffic["precision"])
