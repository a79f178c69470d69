"""The general command-line flags of the train and test entries
(counterpart of ``dynamic_video_depth_tpu/runtime/config.py``; reference
options/options_train.py, options/options_test.py).

Each flag takes the JAX package's default. ``UNIQUE_PARAMS`` are the flags
a resumed run takes from its command line rather than from the saved
``opt.json`` (reference: options/options_train.py:150-162): the JAX set
less its TPU-only names, plus the torch device.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

UNIQUE_PARAMS = frozenset({
    "resume", "epoch", "batch_size", "save_net", "save_every",
    "epoch_batches", "logdir", "full_logdir", "vis_batches_vali",
    "vali_batches", "vali_at_start", "vis_every_vali", "pt_no_overwrite",
    "n_chips", "load_reference_ckpt", "test_template", "device",
    "workers", "profile_dir", "no_device_cache",
})


def add_run_arguments(parser: argparse.ArgumentParser) -> None:
    """Checkpoints, resume, logging and visualization (config.py:16-128)."""
    a = parser.add_argument
    a("--resume", type=int, default=0,
      help="0 scratch; -1 last; -2 best; N epoch N")
    a("--load_reference_ckpt", type=str, default="",
      help="continue from a reference-format training checkpoint "
           "(checkpoint.pt/best.pt: nets and Adam moments)")
    a("--suffix", default="", type=str,
      help="logdir suffix formatted with the options, e.g. '{track_id}'")
    a("--force_overwrite", action="store_true")
    a("--vali_at_start", action="store_true")
    a("--print_net", action="store_true")
    a("--logdir", type=str, default=None)
    a("--full_logdir", type=str, default=None)
    a("--exprdir_no_prefix", action="store_true")
    a("--pt_no_overwrite", action="store_true")
    a("--log_batch", action="store_true")
    a("--progbar_interval", type=float, default=0.05)
    a("--no_accum", action="store_true")
    a("--expr_id", type=int, default=0)
    a("--save_net", type=int, default=1)
    a("--save_net_opt", action="store_true")
    a("--save_every", type=int, default=1,
      help="write checkpoint.pt every N epochs; the last epoch always "
           "writes it")
    a("--vis_every_vali", default=1, type=int)
    a("--vis_every_train", default=1, type=int)
    a("--vis_batches_vali", type=int, default=10)
    a("--vis_batches_train", type=int, default=10)
    a("--tensorboard", action="store_true")
    a("--tensorboard_keyword", type=str, default="checkpoints")
    a("--html_logger", action="store_true")
    a("--vis_workers", default=2, type=int)
    a("--vis_param_f", default=None, type=str)
    a("--vis_at_start", action="store_true")
    a("--test_template", type=str, default=None)


def add_pipeline_arguments(parser: argparse.ArgumentParser) -> None:
    """The input pipeline and the profiler (config.py:47, :119-123)."""
    a = parser.add_argument
    a("--workers", type=int, default=4,
      help="kept for the reference's command lines: one reader thread "
           "loads the batches whatever it says")
    a("--profile_dir", type=str, default=None,
      help="write a torch.profiler trace (Chrome trace JSON, trace.json) "
           "of training epoch min(2, --epoch) here")
    a("--no_device_cache", action="store_true",
      help="copy each batch to the card every step instead of keeping "
           "the video's batches in device memory after their first use")


def exprdir_name(opt) -> str:
    """Experiment directory name (reference: train.py:40-46): the net and
    dataset, then the suffix formatted with the options; with
    ``--exprdir_no_prefix`` the suffix alone."""
    suffix = opt.suffix.format(**vars(opt)) if opt.suffix else ""
    if getattr(opt, "exprdir_no_prefix", False):
        return suffix
    exprdir = f"{opt.net}_{opt.dataset}"
    if suffix:
        exprdir += "_" + suffix
    return exprdir


def tensorboard_logdir(opt, exprdir: str) -> str:
    """TensorBoard directory (reference: train.py:195-202): the run's logdir
    split on ``/{keyword}/``, the event files under
    ``parent/{keyword}/tensorboard/sub``; ``--tensorboard_keyword none``
    uses ``logdir/tensorboard/exprdir/expr_id``. Where the keyword is not in
    the path, ``tensorboard/`` inside the run directory, with a warning."""
    kw = getattr(opt, "tensorboard_keyword", "checkpoints")
    full_logdir = opt.full_logdir
    if kw != "none":
        parts = full_logdir.split(f"/{kw}/")
        if len(parts) == 2:
            return os.path.join(parts[0], kw, "tensorboard", parts[1])
        print(f"Warning: --tensorboard_keyword '{kw}' not found in logdir "
              f"{full_logdir}; writing tensorboard inside the run dir")
        return os.path.join(full_logdir, "tensorboard")
    return os.path.join(opt.logdir or ".", "tensorboard", exprdir,
                        str(opt.expr_id))


def overwrite(opt, opt_old: dict, unique_params=UNIQUE_PARAMS):
    """Resume: take the saved run's options, apart from ``unique_params``
    (reference: options/options_train.py:150-162)."""
    for k, v in opt_old.items():
        if k in unique_params or k.startswith("_"):
            continue
        setattr(opt, k, v)
    return opt


def build_test_parser() -> argparse.ArgumentParser:
    """The test entry's flags (reference: options/options_test.py:24-77);
    ``--net``, ``--dataset``, ``--suffix`` and ``--html_logger`` are taken
    for the reference's test command line and checked against (or ignored
    beside) the checkpoint's ``opt.json``."""
    p = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.test")
    a = p.add_argument
    a("--checkpoint_path", type=str, required=True)
    a("--output_dir", type=str, required=True)
    a("--net", type=str, default=None)
    a("--dataset", type=str, default=None)
    a("--suffix", type=str, default="")
    a("--overwrite", action="store_true")
    a("--html_logger", action="store_true")
    a("--epoch", type=int, default=-1,
      help="epoch checkpoint to load (nets/%%04d.pt); -1 for best.pt")
    a("--manual_seed", type=int, default=None)
    a("--batch_size", type=int, default=1)
    a("--vis_workers", default=2, type=int)
    a("--data_root", type=str, default=None)
    a("--n_chips", type=int, default=1,
      help="devices to spread the frames over, a frame each")
    a("--device", default="cuda", help="torch device; 'cuda' needs a GPU")
    return p


def parse_test(argv: Optional[Sequence[str]] = None):
    """Parse the test entry's flags; unknown flags are reported and left
    out, as the reference's test options do."""
    opt, unknown = build_test_parser().parse_known_args(argv)
    if unknown:
        print(f"Warning: ignoring unknown options {unknown}")
    return opt
