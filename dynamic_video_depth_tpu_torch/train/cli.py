"""Training entry: ``python -m dynamic_video_depth_tpu_torch.train``
(counterpart of the JAX package's ``train.py``; reference train.py).

Takes the flags of ``experiments/davis/train_sequence.sh`` plus ``--device``
(default ``cuda``). A run lives in ``--full_logdir``, by default
``{--logdir or ./checkpoints}/{net}_{dataset}[_{suffix}]/{expr_id}`` with the
suffix formatted with the options. A fresh run refuses a directory that
holds a run unless ``--force_overwrite``; ``--resume -1|-2|N`` continues from
``checkpoint.pt``, ``best.pt`` or ``nets/%04d.pt`` with the saved options
(``opt.json``) apart from ``runtime.config.UNIQUE_PARAMS``;
``--load_reference_ckpt`` continues from a reference-format checkpoint.
Each epoch feeds the loggers (``epoch_loss.csv``, ``--log_batch``,
``--html_logger``, ``--tensorboard``), writes ``checkpoint.pt`` (every
``--save_every`` epochs and at the last), ``nets/%04d.pt`` (every
``--save_net``) and ``best.pt`` (on a better validation loss), and
visualizes the last ``--vis_batches_train`` train batches and the first
``--vis_batches_vali`` validation frames into
``visualize/epoch%04d_{train,vali}/``. After training, ``--test_template``'s
command runs, its ``python test.py`` as this interpreter's
``-m dynamic_video_depth_tpu_torch.test`` with the run's ``--device``; the
run fails if that command fails.

The depth net is ``--depth_net`` when given, else MiDaS with ``--midas`` and
the hourglass without; the MiDaS far-field loss masks follow the same
choice. ``--use_pallas_sf_chain`` and ``--use_pallas_loss`` (``auto|on|off``,
the JAX names) pick the fused chain and fused loss paths: ``auto`` is on for
``--device cuda`` and off on the CPU, where ``on`` runs the kernels' plain
versions. The JAX entry's variants run as there:
``--mixed_precision_training`` (the depth net in bfloat16; ``--full_precision``
forces float32, ``--loss_scaling`` selects nothing), ``--remat_depth``,
``--optim sgd`` (``--sgd_momentum``, ``--sgd_dampening``, ``--wdecay``),
``--use_cnn`` (``FCNUnet`` of ``--n_down`` levels as the scene-flow field),
``--use_embedding``, ``--log_grad_stats`` (gradient norms and maxima in the
step logs and ``epoch_loss.csv``) and ``--dataset shutterstock`` (an
integer ``--track_id`` picks a track by sorted index). ``--n_chips`` other
than 1 raises (several chips train through the fleet entry,
``train/fleet.py``); any other unknown flag is an argparse error.

Example (the canonical DAVIS recipe, ``experiments/davis/train_sequence.sh``
with this entry)::

  python -m dynamic_video_depth_tpu_torch.train --net scene_flow_motion_field \\
      --dataset davis_sequence --track_id dog --log_time --epoch_batches 2000 \\
      --epoch 20 --lr 1e-6 --html_logger --vali_batches 150 --batch_size 1 \\
      --optim adam --vis_batches_vali 4 --vis_every_vali 1 \\
      --vis_every_train 1 --vis_batches_train 5 \\
      --logdir ./checkpoints/davis/sequence/ --suffix 'track_{track_id}' \\
      --test_template ./experiments/davis/test_cmd.txt --force_overwrite \\
      --scene_lr_mul 1000 --warm_sf 5 --acc_mul 1 --disp_mul 1 --flow_mul 1 \\
      --sf_mag_div 100 --time_dependent --gaps 1,2,4,6,8 --midas --use_disp
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from os.path import isfile, join
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..data import DATASETS, get_dataset
from ..data.davis_sequence import Dataset
from ..runtime import config
from ..runtime.checkpoint import (load_checkpoint, load_opt, read_best,
                                  resolve_resume, save_checkpoint, save_opt)
from ..runtime.device import resolve_device
from ..runtime.loggers import (BaseLogger, BatchCsvLogger, ComposeLogger,
                               CsvLogger, HtmlLogger, LogCumulator,
                               ModelSaveLogger, ProgbarLogger,
                               TensorBoardLogger, TerminateOnNaN)
from ..utils.printing import set_manual_seed
from ..utils.visualizer import HTMLVisualizer
from .loop import Trainer, vis_index
from .scene_flow_motion_field import Model, numpy_dict, step_config
from .step import FUSED_MODES, OPTIMS

__all__ = ["build_parser", "build_run", "build_trainer", "main",
           "step_config"]

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamic_video_depth_tpu_torch.train")
    a = p.add_argument
    a("--net", default="scene_flow_motion_field",
      choices=["scene_flow_motion_field"])
    a("--dataset", default="davis_sequence", choices=DATASETS)
    Dataset.add_arguments(p)
    a("--device", default="cuda", help="torch device; 'cuda' needs a GPU")
    a("--manual_seed", type=int, default=None)
    a("--epoch", type=int, default=0)
    a("--epoch_batches", type=int, default=None)
    a("--vali_batches", type=int, default=None)
    a("--batch_size", type=int, default=16)
    a("--no_batching", action="store_true",
      help="one sample per step whatever --batch_size says")
    a("--log_time", action="store_true",
      help="add each batch's time to its logs and print the epoch's phases")
    a("--optim", default="adam", choices=OPTIMS)
    a("--lr", type=float, default=1e-4)
    a("--adam_beta1", type=float, default=0.5)
    a("--adam_beta2", type=float, default=0.9)
    a("--sgd_momentum", type=float, default=0.9)
    a("--sgd_dampening", type=float, default=0)
    a("--wdecay", type=float, default=0.0)
    a("--init_type", default="kaiming")
    a("--scene_lr_mul", type=float, default=1.0)
    a("--warm_sf", type=int, default=0)
    a("--flow_mul", type=float, default=10.0)
    a("--disp_mul", type=float, default=10.0)
    a("--acc_mul", type=float, default=100.0)
    a("--sf_mag_div", type=float, default=100.0)
    a("--interp_steps", type=int, default=5)
    a("--n_freq_xyz", type=int, default=16)
    a("--n_freq_t", type=int, default=16)
    a("--n_down", type=int, default=3, help="--use_cnn: FCNUnet levels")
    for flag in ("--time_dependent", "--use_disp", "--use_disp_ratio",
                 "--use_motion_seg", "--weight_steps", "--warm_reg",
                 "--use_cnn", "--use_embedding", "--log_grad_stats"):
        a(flag, action="store_true")
    a("--loss_type", type=str, default="l2",
      help="kept for the recipe's logdir suffix; as in the JAX package, "
           "it selects nothing")
    a("--midas", action="store_true", help="MiDaS depth net and loss masks")
    a("--depth_net", default="",
      help="'' defers to --midas; 'midas', 'hourglass' or 'tiny' (tests)")
    for knob in ("sf_chain", "loss"):
        a(f"--use_pallas_{knob}", choices=FUSED_MODES, default="auto",
          help="fused path: auto = on for a CUDA device, off on the CPU")
    a("--mixed_precision_training", action="store_true",
      help="run the depth net in bfloat16 (float32 params and updates)")
    a("--loss_scaling", type=float, default=255,
      help="kept for the reference's command lines; bfloat16 needs no "
           "loss scaling, so it selects nothing")
    a("--full_precision", action="store_true",
      help="force float32 depth compute")
    a("--remat_depth", action="store_true",
      help="recompute the depth forward in the backward pass")
    config.add_run_arguments(p)
    a("--n_chips", type=int, default=1,
      help="only 1: several chips train through the fleet entry")
    return p


def _refuse_unported(opt) -> None:
    """The JAX entry parses ``--n_chips`` and ignores it; this one refuses
    it and names the entry that trains over several chips."""
    if opt.n_chips != 1:
        raise NotImplementedError(
            "--n_chips is not ported to the single-video entry: train over "
            "several chips with python -m dynamic_video_depth_tpu_torch."
            "train.fleet --tracks T --dp N")


class _RunHooks(BaseLogger):
    """The run's own epoch-end work: the visualizer's PNGs written, and
    ``checkpoint.pt`` at the last epoch when it is off the ``--save_every``
    period (JAX train.py:316-322); at the end of training, even a failed
    one, the visualizer drained and closed."""

    def __init__(self, run: "Run"):
        super().__init__()
        self.run = run

    def on_epoch_end(self, epoch, logs=None):
        run = self.run
        t0 = time.perf_counter()
        run.visualizer.flush()
        run.vis_seconds[epoch] = (run.vis_seconds.get(epoch, 0.0)
                                  + time.perf_counter() - t0)
        every = max(run.opt.save_every, 1)
        if epoch == run.opt.epoch and epoch % every:
            run.save(join(run.logdir, "checkpoint.pt"), epoch=epoch,
                     best=run.best_holder["best"])

    def on_train_end(self):
        self.run.visualizer.close()


class Run:
    """One training run: its options, directory, model, loggers,
    visualizer and trainer. ``train`` trains and then runs the chained
    test command; a caller may change the nets between ``build_run`` and
    ``train`` (a fixture biases a random-weight MiDaS there)."""

    def __init__(self, opt, on_epoch_end: Optional[Callable] = None):
        self.opt = opt
        self.device = resolve_device(opt.device)
        if opt.manual_seed is not None:
            set_manual_seed(opt.manual_seed)
        exprdir = config.exprdir_name(opt)
        if opt.full_logdir is None:
            opt.full_logdir = join(opt.logdir or "./checkpoints", exprdir,
                                   str(opt.expr_id))
        self.logdir = logdir = opt.full_logdir
        self._guard_fresh_run()
        os.makedirs(join(logdir, "nets"), exist_ok=True)
        resume_path = resolve_resume(logdir, opt.resume)
        if opt.resume != 0 and isfile(join(logdir, "opt.json")):
            opt = self.opt = config.overwrite(opt, load_opt(logdir))
        if opt.pt_no_overwrite and isfile(join(logdir, "opt.json")):
            print("Warning: --pt_no_overwrite set, keeping existing opt.json")
        else:
            save_opt(logdir, opt)

        # save timings (path, seconds, bytes) and visualization seconds per
        # epoch, for whoever drives the run
        self.saves: List[tuple] = []
        self.vis_seconds = {}
        self.visualizer = HTMLVisualizer(n_workers=opt.vis_workers)
        self.best_holder = {"best": float("inf")}
        cumulator = LogCumulator()
        loggers = [cumulator,
                   ProgbarLogger(interval=opt.progbar_interval,
                                 no_accum=opt.no_accum),
                   CsvLogger(join(logdir, "epoch_loss.csv"), cumulator),
                   TerminateOnNaN()]
        if opt.log_batch:
            loggers.append(BatchCsvLogger(join(logdir, "batch_loss.csv")))
        if opt.tensorboard:
            loggers.append(TensorBoardLogger(
                config.tensorboard_logdir(opt, exprdir), cumulator))
        if opt.html_logger:
            loggers.append(HtmlLogger(join(logdir, "html"), cumulator))

        self.model = Model(opt, device=self.device,
                           seed=opt.manual_seed or 0)
        dataset = get_dataset(opt.dataset)
        train, vali = dataset(opt, "train"), dataset(opt, "vali")
        print(f"#train pairs: {len(train)}  #vali frames: {len(vali)}  "
              f"device: {self.device}", flush=True)
        if opt.print_net:
            for name, n in self.model.count_params().items():
                print(f"{name}: {n / 1e6:.2f}M params")

        self.start_epoch = 1
        if resume_path and not isfile(resume_path):
            print(f"Warning: --resume {opt.resume}: {resume_path} not found; "
                  "not resuming", flush=True)
        if resume_path and isfile(resume_path):
            meta = load_checkpoint(resume_path, self.model.step)
            self.start_epoch = int(meta.get("epoch", 0)) + 1
            print(f"Resumed from {resume_path} at epoch "
                  f"{self.start_epoch - 1}", flush=True)
            best = read_best(join(logdir, "best.pt"))
            if best is not None:
                self.best_holder["best"] = best
                print(f"Restored best vali loss {best:.6g}")
        elif opt.load_reference_ckpt:
            meta = load_checkpoint(opt.load_reference_ckpt, self.model.step)
            self.start_epoch = int(meta.get("epoch", 0)) + 1
            print(f"Loaded reference checkpoint {opt.load_reference_ckpt} "
                  f"(epoch {self.start_epoch - 1}); continuing at "
                  f"{self.start_epoch}", flush=True)

        loggers.append(ModelSaveLogger(
            self.save, join(logdir, "checkpoint.pt"),
            period=max(opt.save_every, 1), cumulator=cumulator,
            best_holder=self.best_holder))
        if opt.save_net > 0:
            loggers.append(ModelSaveLogger(
                self.save_net, join(logdir, "nets", "%04d.pt"),
                period=opt.save_net, cumulator=cumulator,
                best_holder=self.best_holder))
        loggers.append(ModelSaveLogger(
            self.save, join(logdir, "best.pt"), save_best_only=True,
            cumulator=cumulator, best_holder=self.best_holder))
        loggers.append(_RunHooks(self))
        self.logger = ComposeLogger(loggers)
        self.trainer = Trainer(self.model.step, train, vali, opt,
                               logger=self.logger,
                               visualize_fn=self.visualize,
                               on_epoch_end=on_epoch_end)
        self.trainer.start_epoch = self.start_epoch

    def _guard_fresh_run(self) -> None:
        """A fresh run into a directory that holds a run is refused, or,
        with ``--force_overwrite``, the old run is removed (reference
        train.py:51-77, non-interactive)."""
        opt, logdir = self.opt, self.logdir
        if opt.resume != 0 or not isfile(join(logdir, "checkpoint.pt")):
            return
        if not opt.force_overwrite:
            raise SystemExit(
                f"Refusing to overwrite the existing experiment at {logdir}; "
                "pass --force_overwrite to replace it or --resume -1 to "
                "continue it")
        print(f"Warning: removing previous experiment at {logdir} "
              "(--force_overwrite)")
        shutil.rmtree(logdir)

    def save(self, path: str, epoch: int = 0, best: float = float("inf"),
             include_opt: bool = True) -> None:
        t0 = time.perf_counter()
        save_checkpoint(path, self.model.step, epoch=epoch, best=best,
                        include_opt=include_opt)
        self.saves.append((path, time.perf_counter() - t0,
                           os.path.getsize(path)))

    def save_net(self, path: str, epoch: int = 0,
                 best: float = float("inf")) -> None:
        """``nets/%04d.pt``: weights only unless ``--save_net_opt``."""
        self.save(path, epoch=epoch, best=best,
                  include_opt=self.opt.save_net_opt)

    def visualize(self, phase, epoch, batch_idx, dev, host, n_steps,
                  pred=None) -> None:
        """Dump a train batch (its pair through ``forward_vis``) or a
        validation frame (its prediction) as PNGs, a row of the epoch's
        ``index.html`` and ``rank0000_batch%04d.npz``."""
        opt = self.opt
        every = opt.vis_every_train if phase == "train" else opt.vis_every_vali
        if every <= 0 or epoch % every != 0:
            return
        t0 = time.perf_counter()
        if phase == "train":
            idx = vis_index(batch_idx, n_steps, opt.vis_at_start)
            if idx > opt.vis_batches_train:
                return
            pred = self.model.vis_on_batch(dev, host["steps"])
        else:
            # validation counts from the start (reference video_base.py:90)
            idx = batch_idx
            if batch_idx >= opt.vis_batches_vali:
                return
            pred = numpy_dict(pred)
        outdir = join(self.logdir, "visualize", f"epoch{epoch:04d}_{phase}")
        output = self.model.pack_output(pred, host)
        # the page is keyed by the gate index, the npz by the batch index
        # (reference scene_flow_motion_field.py:216-225, video_base.py:98)
        self.visualizer.visualize(output, idx + 1000 * epoch, outdir)
        np.savez(join(outdir, "rank0000_batch%04d" % batch_idx), **output)
        self.vis_seconds[epoch] = (self.vis_seconds.get(epoch, 0.0)
                                   + time.perf_counter() - t0)

    def test_command(self) -> Optional[str]:
        """``--test_template``'s command formatted with the options, its
        ``python test.py`` this interpreter's test entry on the run's
        device; ``None`` without a template file."""
        opt = self.opt
        if not (opt.test_template and isfile(opt.test_template)):
            return None
        with open(opt.test_template) as f:
            cmd = f.read().strip()
        cmd = cmd.format(net_file=join(self.logdir, "best.pt"), **vars(opt))
        return cmd.replace(
            "python test.py",
            f'"{sys.executable}" -m dynamic_video_depth_tpu_torch.test', 1
        ) + f" --device {opt.device}"

    def chain_test(self) -> None:
        cmd = self.test_command()
        if cmd is None:
            return
        print("Running test command:", cmd, flush=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        rc = subprocess.call(cmd, shell=True, env=env)
        if rc != 0:
            raise SystemExit(f"chained test command failed (rc={rc})")

    def train(self) -> Trainer:
        self.trainer.train(self.start_epoch)
        self.chain_test()
        return self.trainer


def build_run(argv: Optional[Sequence[str]] = None,
              on_epoch_end: Optional[Callable] = None) -> Run:
    """Parse the flags and set the run up: its directory, model, datasets,
    loggers and trainer, resumed or loaded as the flags say."""
    opt = build_parser().parse_args(argv)
    _refuse_unported(opt)
    return Run(opt, on_epoch_end=on_epoch_end)


def build_trainer(argv: Optional[Sequence[str]] = None,
                  on_epoch_end: Optional[Callable] = None) -> Trainer:
    """``build_run(argv).trainer``: its ``train()`` trains without the
    chained test command."""
    return build_run(argv, on_epoch_end).trainer


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    return build_run(argv).train()
