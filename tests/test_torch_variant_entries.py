"""The ShutterStock recipe and the variant recipes through the entries,
against the JAX package's, on the CPU.

- ShutterStock: the train and validation items and the integer
  ``--track_id`` selection against the JAX ``Dataset``; the recipe's flag
  list and the variant flags' step configuration.
- The entries end to end: the variant recipe (``--use_cnn``, SGD,
  ``--log_grad_stats``, ``--remat_depth``) and ``--mixed_precision_training``
  through the train and test entries.
"""

import json
import os
import shlex
from argparse import Namespace

import numpy as np
import pytest
import torch

from chip_smoke import state_equal
from dynamic_video_depth_tpu_torch.models import FCNUnet
from dynamic_video_depth_tpu_torch.train import cli
from test_torch_variants import GRAD_KEYS
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))


# --------------------------------------------------------- ShutterStock


@pytest.fixture(scope="module")
def ss_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("shutterstock"))
    for i, track in enumerate(("beach", "alley", "cliff")):
        make_track(root, track=track, n_frames=4, h=32, w=48, gaps=(1, 2),
                   seed=i)
    return root


def _ss_opt(root, track):
    return Namespace(track_id=track, data_root=root, gaps="1,2",
                     subsample=False, repeat=1, overfit=False, cache=False)


@pytest.mark.parametrize("track,name", [("0", "alley"), ("2", "cliff"),
                                        ("4", "beach"), ("cliff", "cliff")])
def test_shutterstock_items_match_jax(ss_root, track, name):
    """An integer ``--track_id`` picks the sorted index (mod the count);
    the train and validation items equal the JAX reader's."""
    from dynamic_video_depth_tpu.data import get_dataset as jax_dataset
    from dynamic_video_depth_tpu_torch.data import get_dataset

    for mode in ("train", "vali"):
        opt, ref_opt = _ss_opt(ss_root, track), _ss_opt(ss_root, track)
        ours = get_dataset("shutterstock")(opt, mode)
        ref = jax_dataset("shutterstock")(ref_opt, mode)
        assert opt.track_id == ref_opt.track_id == name
        assert len(ours) == len(ref) > 0
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            # the JAX reader adds its TPU warp's row window to a pair
            assert set(b) - set(a) <= {"warp_window"} and set(a) <= set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


def _shutterstock_flags(track="0"):
    """The flags between ``python train.py`` and ``"$@"`` in
    ``experiments/shutterstock/train_sequence.sh``."""
    path = os.path.join(HERE, "..", "experiments", "shutterstock",
                        "train_sequence.sh")
    with open(path) as f:
        body = f.read().split("python train.py", 1)[1].split('"$@"', 1)[0]
    return shlex.split(body.replace("\\\n", " ").replace("${track}", track))


def test_shutterstock_recipe_flag_list_parses():
    opt = cli.build_parser().parse_args(_shutterstock_flags())
    assert (opt.dataset, opt.track_id, opt.gaps, opt.midas) == (
        "shutterstock", "0", "1,2,4,6,8", True)
    assert opt.test_template.endswith("shutterstock/test_cmd.txt")
    cfg = cli.step_config(opt)
    assert (cfg.optim, cfg.compute_dtype, cfg.use_cnn) == ("adam", "float32",
                                                            False)


@pytest.mark.parametrize("extra,want", [
    ([], dict(compute_dtype="float32", optim="adam")),
    (["--mixed_precision_training", "--loss_scaling", "128"],
     dict(compute_dtype="bfloat16")),
    (["--mixed_precision_training", "--full_precision"],
     dict(compute_dtype="float32")),
    (["--optim", "sgd", "--sgd_momentum", "0.5", "--sgd_dampening", "0.1",
      "--wdecay", "1e-4"],
     dict(optim="sgd", sgd_momentum=0.5, sgd_dampening=0.1, wdecay=1e-4)),
    (["--use_cnn", "--n_down", "2", "--use_embedding", "--remat_depth",
      "--log_grad_stats"],
     dict(use_cnn=True, n_down=2, use_embedding=True, remat_depth=True,
          log_grad_stats=True))])
def test_step_config_maps_variant_flags(extra, want):
    opt = cli.build_parser().parse_args(["--track_id", "dog"] + extra)
    cfg = cli.step_config(opt)
    assert {k: getattr(cfg, k) for k in want} == want


# ------------------------------------------------ the entries, end to end


VARIANTS = ["--use_cnn", "--optim", "sgd", "--sgd_dampening", "0.1",
            "--wdecay", "1e-4", "--log_grad_stats", "--remat_depth"]


def test_variant_recipe_through_the_entries(ss_root, tmp_path, monkeypatch):
    """The ShutterStock recipe's flags with the variants (``--use_cnn``,
    SGD, ``--log_grad_stats``, ``--remat_depth``) and an integer track id,
    the tiny depth net on the CPU: a warm-up and a main epoch, the grad-stat
    columns of ``epoch_loss.csv`` (depth terms 0 in warm-up, above 0 after),
    SGD momentum buffers in ``checkpoint.pt`` restored bit for bit by
    ``--resume -1``, and the chained test command of
    ``experiments/shutterstock/test_cmd.txt`` (its output directory is
    relative to the working directory)."""
    import csv

    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        read_checkpoint)

    monkeypatch.chdir(tmp_path)
    common = ["--epoch_batches", "3", "--vali_batches", "2", "--batch_size",
              "1", "--device", "cpu"]
    flags = _shutterstock_flags("0") + common + VARIANTS + [
        "--depth_net", "tiny", "--data_root", ss_root, "--gaps", "1,2",
        "--epoch", "2", "--warm_sf", "1", "--logdir", str(tmp_path / "runs"),
        "--manual_seed", "0", "--lr", "1e-4", "--scene_lr_mul", "10",
        "--test_template", os.path.join(HERE, "..", "experiments",
                                        "shutterstock", "test_cmd.txt")]
    run = cli.build_run(flags)
    step = run.model.step
    assert run.opt.track_id == "alley"  # index 0 of the sorted tracks
    assert run.logdir.endswith("shutterstock_track_0_midas_True/0")
    assert type(step.net_sf) is FCNUnet and not step.chain_fused
    assert isinstance(step.opt_depth, torch.optim.SGD)
    run.train()

    with open(os.path.join(run.logdir, "epoch_loss.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [1, 2]
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in GRAD_KEYS)
    assert float(rows[0]["grad_norm_depth"]) == 0.0
    assert float(rows[0]["grad_max_depth"]) == 0.0
    assert float(rows[1]["grad_norm_depth"]) > 0.0
    assert float(rows[1]["grad_max_depth"]) > 0.0
    assert all(float(r["grad_norm_sf"]) > 0.0 for r in rows)

    ckpt = read_checkpoint(os.path.join(run.logdir, "checkpoint.pt"))
    for sd in ckpt["optimizers"]:
        assert sd["state"] and all("momentum_buffer" in s
                                   for s in sd["state"].values())
        assert sd["param_groups"][0]["dampening"] == 0.1
    resumed = cli.build_run(["--full_logdir", run.logdir, "--resume", "-1",
                             "--epoch", "3"] + common)
    rstep = resumed.model.step
    assert resumed.start_epoch == 3
    assert isinstance(rstep.opt_sf, torch.optim.SGD)
    assert state_equal([o.state_dict() for o in rstep.optimizers],
                        ckpt["optimizers"])
    assert state_equal([rstep.net_depth.state_dict(),
                         rstep.net_sf.state_dict()], ckpt["nets"])

    out = tmp_path / "test_results" / "shutterstock" / "track_alley"
    with open(out / "epochbest_test.json") as f:
        summary = json.load(f)
    assert summary["frames"] == 4 and summary["launches"]["mlp_fwd"] == 0
    assert (out / "epochbest_test" / "batch0003.npz").is_file()


def test_bf16_run_and_test_entry(tmp_path):
    """``--mixed_precision_training`` through the train entry and the test
    entry: the test entry predicts in the checkpoint's compute dtype, so
    its npz depth equals an in-process bfloat16 ``predict`` of ``best.pt``
    bit for bit, and differs from a float32 one."""
    from dynamic_video_depth_tpu_torch import test as test_entry
    from dynamic_video_depth_tpu_torch.data import get_dataset
    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint, load_opt)
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    root = str(tmp_path / "davis")
    make_track(root, track="dog", n_frames=4, h=32, w=48, gaps=(1,))
    logdir = str(tmp_path / "run")
    run = cli.build_run([
        "--track_id", "dog", "--gaps", "1", "--data_root", root,
        "--depth_net", "tiny", "--mixed_precision_training", "--epoch", "2",
        "--warm_sf", "1", "--epoch_batches", "2", "--vali_batches", "2",
        "--batch_size", "1", "--time_dependent", "--use_disp", "--device",
        "cpu", "--full_logdir", logdir, "--manual_seed", "0"])
    assert run.model.step.compute_dtype == torch.bfloat16
    hist = run.train().history
    assert all(np.isfinite(r["loss"]) for r in hist)
    test_entry.main(["--checkpoint_path", logdir, "--output_dir",
                     str(tmp_path / "test"), "--device", "cpu"])

    opt = Namespace(**load_opt(logdir))
    preds = {}
    for dtype in (True, False):
        opt.mixed_precision_training = dtype
        model = Model(opt, device="cpu", pretrained=False)
        load_checkpoint(os.path.join(logdir, "best.pt"), model.step)
        ds = get_dataset(opt.dataset)(opt, "vali")
        preds[dtype] = [model.step.predict(to_device(ds[i], "cpu"))
                        ["depth"].numpy() for i in range(len(ds))]
    for i, depth in enumerate(preds[True]):
        dump = np.load(tmp_path / "test" / "epochbest_test" /
                       f"batch{i:04d}.npz")
        np.testing.assert_array_equal(dump["depth"], depth)
        assert not np.array_equal(depth, preds[False][i])
