"""The port's epoch loop and train entry against the JAX package's.

Both trainers run at the same seed over the same synthetic pair list (gaps
1/2/4) with a recording stand-in for the step, and must feed their steps the
same dataset indices in the same order; the port's parser must default
every flag it shares with the JAX parser as the JAX parser does, apart from
the differences listed below with their reasons.
"""

import argparse
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch.train import cli
from dynamic_video_depth_tpu_torch.train.loop import LOG_KEYS
from dynamic_video_depth_tpu_torch.train.loop import Trainer as PortTrainer
from torch_threads import one_torch_thread  # noqa: F401

PAIRS_PER_GAP = {1: 17, 2: 16, 4: 14}  # 47 pairs; 5 groups of 8
EPOCHS = 3


class PairList:
    """A DAVIS-like training set: packed-pair file names by gap; a sample
    carries only its own index."""

    def __init__(self):
        self.file_list = [f"shuffle_False_gap_{g:02d}_{k:03d}.pt"
                          for g, n in PAIRS_PER_GAP.items() for k in range(n)]

    def __len__(self):
        return len(self.file_list)

    def gap_of(self, idx):
        return int(self.file_list[idx].split("_gap_")[1][:2])

    def __getitem__(self, idx):
        return {"idx": np.array([idx], np.int64), "steps": self.gap_of(idx)}


def _opt(batch_size, epoch_batches, no_batching, seed):
    return SimpleNamespace(
        manual_seed=seed, batch_size=batch_size, no_batching=no_batching,
        epoch=EPOCHS, epoch_batches=epoch_batches, warm_sf=1,
        vali_batches=None, vali_at_start=False, steps_per_dispatch=1,
        no_device_cache=False, log_time=False, profile_dir=None)


class _JaxRecorder:
    """Stands in for the JAX trainer's model: records each step's indices."""

    def __init__(self):
        self.seen = []

    def train_on_batch(self, epoch, i, dev, warm=False, steps=None,
                       warp_window=None):
        self.seen.append(tuple(int(v) for v in np.asarray(dev["idx"])))
        return {"loss": 0.0}


class _PortRecorder:
    """Stands in for the port's step: records each step's indices."""

    device = "cpu"

    def __init__(self):
        self.seen = []

    def train_step(self, batch, steps, warm):
        self.seen.append(tuple(int(v) for v in batch["idx"].tolist()))
        return {k: torch.tensor(0.0) for k in LOG_KEYS}


def _jax_sequence(opt):
    from dynamic_video_depth_tpu.runtime.loggers import ComposeLogger
    from dynamic_video_depth_tpu.train.loop import Trainer as JaxTrainer

    model = _JaxRecorder()
    JaxTrainer(model, PairList(), None, ComposeLogger([]), opt).train()
    return model.seen


def _port_sequence(opt):
    step = _PortRecorder()
    PortTrainer(step, PairList(), None, opt).train()
    return step.seen


@pytest.mark.parametrize("no_batching", [False, True])
@pytest.mark.parametrize("epoch_batches", [None, 12])
@pytest.mark.parametrize("batch_size", [1, 8])
def test_trainers_visit_the_same_pairs(batch_size, epoch_batches,
                                       no_batching):
    opt = _opt(batch_size, epoch_batches, no_batching, seed=0)
    want = _jax_sequence(opt)
    got = _port_sequence(opt)
    grouped = batch_size > 1 and not no_batching
    per_epoch = epoch_batches or (5 if grouped else len(PairList()))
    assert len(want) == EPOCHS * per_epoch
    assert {len(ix) for ix in want} == {8 if grouped else 1}
    assert got == want


@pytest.mark.parametrize("seed", [None, 3])
def test_trainers_visit_the_same_pairs_at_other_seeds(seed):
    """The recipe's flags (--batch_size 1 --epoch_batches) at no seed and
    at another seed."""
    opt = _opt(1, 12, False, seed=seed)
    assert _port_sequence(opt) == _jax_sequence(opt)


def _jax_parser():
    from dynamic_video_depth_tpu.data import get_dataset
    from dynamic_video_depth_tpu.models import get_model
    from dynamic_video_depth_tpu.runtime.config import add_general_arguments

    parser, _ = add_general_arguments(argparse.ArgumentParser())
    get_dataset("davis_sequence").add_arguments(parser)
    get_model("scene_flow_motion_field").add_arguments(parser)
    return parser


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


# Flags both parsers have whose defaults differ on purpose.
DELIBERATE = {
    # the JAX parser requires them; the port defaults to the recipe's
    "net": "scene_flow_motion_field",
    "dataset": "davis_sequence",
}

# The variant flags: bfloat16 compute, remat, SGD, the CNN field, the
# hourglass embedding flag and gradient statistics (JAX runtime/config.py,
# train/scene_flow_motion_field.py).
VARIANT_FLAGS = (
    "mixed_precision_training", "full_precision", "loss_scaling",
    "remat_depth", "optim", "sgd_momentum", "sgd_dampening", "wdecay",
    "use_cnn", "n_down", "use_embedding", "log_grad_stats")

# The recipe's run flags: checkpoints, resume, loggers, visualization and
# the chained test entry (JAX runtime/config.py:16-128).
RUN_FLAGS = (
    "logdir", "full_logdir", "suffix", "expr_id", "exprdir_no_prefix",
    "force_overwrite", "pt_no_overwrite", "resume", "load_reference_ckpt",
    "save_net", "save_net_opt", "save_every", "vali_at_start", "log_batch",
    "progbar_interval", "no_accum", "print_net", "vis_every_vali",
    "vis_every_train", "vis_batches_vali", "vis_batches_train",
    "vis_workers", "vis_at_start", "vis_param_f", "html_logger",
    "tensorboard", "tensorboard_keyword", "test_template")


# The input pipeline, the profiler, the dataset's flags and the
# reference's loss flags that select nothing (JAX runtime/config.py,
# data/davis_sequence.py:27-42, train/scene_flow_motion_field.py:38-59).
PIPELINE_FLAGS = (
    "no_device_cache", "profile_dir", "workers", "cache", "repeat",
    "overfit", "capat", "select", "l1_mul", "one_way", "sf_min_mul",
    "sf_quantile", "static", "static_mul", "si_mul", "cos_mul",
    "motion_seg_hard", "warm_mul", "warm_static")

# The JAX flags the port leaves out on purpose, each with its reason.
ABSENT = {
    "dense_group_width": "TPU workaround: dense-layer grouping for the MXU",
    "merge_group_width": "TPU workaround: merge grouping for the MXU",
    "merge_reducers": "TPU workaround: reduction merging for XLA",
    "s2d_min_pixels": "TPU workaround: space-to-depth convolutions",
    "steps_per_dispatch": "TPU workaround: lax.scan dispatch of K steps",
    "use_pallas_sf": "its off would put kernel B's plain version on the "
                     "card's main path",
    "use_pallas_warp": "its off would put kernel A's plain version on the "
                       "card's main path",
    "gpu": "reference launcher flag: --device picks the card",
    "init_url": "reference launcher flag: the fleet entry has its own",
    "dist_backend": "reference launcher flag: the fleet entry has its own",
    "multiprocess_distributed": "reference launcher flag: the fleet entry "
                                "spawns its ranks",
    "node_rank": "reference launcher flag: one host",
    "world_size": "reference launcher flag: the fleet entry's layout "
                  "sets it",
}


def test_parser_defaults_match_jax():
    port = _defaults(cli.build_parser())
    jax = _defaults(_jax_parser())
    shared = sorted(set(port) & set(jax))
    assert set(RUN_FLAGS) <= set(shared)
    assert set(VARIANT_FLAGS) <= set(shared)
    assert set(PIPELINE_FLAGS) <= set(shared)
    assert len(shared) >= 78 + len(PIPELINE_FLAGS)
    differ = {k: port[k] for k in shared if port[k] != jax[k]}
    assert differ == DELIBERATE
    # flags only the port has: the torch device (the JAX package picks its
    # backend itself)
    assert sorted(set(port) - set(jax)) == ["device"]
    # flags only the JAX package has: the deliberate absences, no more
    assert set(jax) - set(port) == set(ABSENT)


def test_batch_size_defaults_to_16_and_no_batching_parses():
    base = ["--track_id", "dog"]
    opt = cli.build_parser().parse_args(base)
    assert (opt.batch_size, opt.no_batching) == (16, False)
    opt = cli.build_parser().parse_args(base + ["--no_batching"])
    assert opt.no_batching
