"""The port's recipe (train entry, checkpoints, resume, the test entry)
against the JAX package's, on the CPU with the tiny depth net at 32x48.

The port trains; its reference-format ``checkpoint.pt`` goes into the JAX
model through ``runtime/migrate.py::import_reference_checkpoint``, and both
trainers then run the next epoch at the same seed (the JAX step on its
plain XLA paths, the port's on its plain versions): the per-step losses
agree at rtol 1e-5 and the final parameters at rtol 1e-4 / atol 1e-6 (the
tolerances of ``test_torch_step.py``). This is done at the warm-up boundary
(the depth Adam has no state yet) and after it, and once from a checkpoint
that the JAX package's ``export_reference_checkpoint`` wrote, loaded through
``--load_reference_ckpt``. The test entry's dumps and metrics and the
visualization forward are held to the JAX model at the same weights.

The depth net's parameters meet that tolerance everywhere. The full-width
scene-flow MLP's meet it on ``SF_SHARE`` of its weights, and every weight
lies within one Adam step (``lr * scene_lr_mul``) of the JAX one: points
whose hidden pre-activations lie within roundoff of 0 take different
leaky-relu slopes in the two float32 computations (the case that
``chip_smoke.flip_points`` excludes from the kernel checks), and Adam's
normalisation turns the small gradient change into up to a sixth of a step
on some hundred weights (measured on this fixture at seeds 0-3: at most 208
of 297,987 weights outside the tolerance, at most 1.4e-4 apart with steps
of 1e-3). An epoch is one step (``--epoch_batches 1``), so each comparison
is one update from the imported state; after three updates about 1% of the
weights part by more than the tolerance.
"""

import os
import re
import shlex
import shutil
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch import test as test_entry
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.runtime.checkpoint import (load_opt,
                                                              read_checkpoint)
from dynamic_video_depth_tpu_torch.train import cli
from dynamic_video_depth_tpu_torch.train.loop import LOG_KEYS
from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import Model
from torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(HERE, "..", "experiments", "davis", "train_sequence.sh")
TEST_CMD = os.path.join(HERE, "..", "experiments", "davis", "test_cmd.txt")
STEP_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
SF_SHARE = 0.99

FLAGS = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
         "--track_id", "dog", "--gaps", "1,2", "--epoch_batches", "1",
         "--warm_sf", "1", "--lr", "1e-4", "--scene_lr_mul", "10",
         "--time_dependent", "--use_disp", "--vali_batches", "2",
         "--batch_size", "1", "--depth_net", "tiny", "--manual_seed", "0"]


def recipe_flags():
    """The flags between ``python train.py`` and ``"$@"`` in the recipe,
    with the script's ``${track}`` as ``dog``."""
    with open(RECIPE) as f:
        text = f.read()
    body = text.split("python train.py", 1)[1].split('"$@"', 1)[0]
    return shlex.split(body.replace("\\\n", " ").replace("${track}", "dog"))


def test_recipe_flag_list_parses():
    flags = recipe_flags()
    assert "--test_template" in flags and "--html_logger" in flags
    opt = cli.build_parser().parse_args(flags)
    assert (opt.epoch, opt.epoch_batches, opt.vis_batches_train,
            opt.vis_batches_vali, opt.gaps) == (20, 2000, 5, 4, "1,2,4,6,8")
    assert opt.midas and opt.html_logger and opt.force_overwrite
    from dynamic_video_depth_tpu_torch.runtime.config import exprdir_name
    assert exprdir_name(opt) == (
        "scene_flow_motion_field_davis_sequence_track_dog_l2_wreg_False_acc_"
        "1.0_disp_1.0_flowmul_1.0_time_True_CNN_False_sf_100.0_mask_False_"
        "midas_True")


def test_chained_test_command_runs_the_port_entry(tmp_path, track_root):
    run = cli.build_run(FLAGS + [
        "--data_root", track_root, "--device", "cpu", "--epoch", "1",
        "--logdir", str(tmp_path), "--test_template", TEST_CMD])
    cmd = run.test_command()
    assert "-m dynamic_video_depth_tpu_torch.test" in cmd
    assert "test.py" not in cmd
    assert cmd.endswith(f"--output_dir {run.logdir}/test --device cpu")


@pytest.fixture(scope="module")
def track_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("recipe_track"))
    make_track(root, track="dog", n_frames=6, h=32, w=48, gaps=(1, 2))
    return root


def _port(root, logdir, *extra):
    return cli.main(FLAGS + ["--data_root", root, "--device", "cpu",
                             "--full_logdir", logdir] + list(extra))


class _Recorder:
    """A JAX logger that keeps every batch's logs."""

    def __init__(self):
        from dynamic_video_depth_tpu.runtime.loggers import BaseLogger

        self.logs = []
        rec = self

        class Logger(BaseLogger):
            def on_batch_end(self, batch, logs=None):
                rec.logs.append({k: float(v) for k, v in logs.items()})

        self.logger = Logger()


class JaxSide:
    """The JAX model and datasets over the same track and flags."""

    def __init__(self, root):
        from dynamic_video_depth_tpu.data import get_dataset
        from dynamic_video_depth_tpu.models import get_model
        from dynamic_video_depth_tpu.runtime import config as jcfg

        self.opt, _ = jcfg.parse(FLAGS + ["--data_root", root])
        self.model = get_model(self.opt.net)(self.opt, None)
        ds = get_dataset(self.opt.dataset)
        self.train_ds = ds(self.opt, mode="train", model=self.model)
        self.vali_ds = ds(self.opt, mode="vali", model=self.model)
        self.model.init_from_sample(self.train_ds[0]["img_1"], seed=0)

    def load(self, path, load_optimizer="auto"):
        from dynamic_video_depth_tpu.runtime.migrate import (
            import_reference_checkpoint)

        self.model.state, extras = import_reference_checkpoint(
            path, self.model.step, self.model.state,
            load_optimizer=load_optimizer)
        return extras

    def train_epoch(self, epoch):
        """One epoch at ``epoch`` from the current state, a fresh trainer
        at the seed (as a resumed run starts); its per-step logs."""
        from dynamic_video_depth_tpu.runtime.loggers import (ComposeLogger,
                                                             LogCumulator)
        from dynamic_video_depth_tpu.train.loop import Trainer

        rec = _Recorder()
        self.opt.epoch = epoch
        Trainer(self.model, self.train_ds, self.vali_ds,
                ComposeLogger([LogCumulator(), rec.logger]),
                self.opt).train(start_epoch=epoch)
        return rec.logs

    def params(self):
        s = self.model.state
        return ({"params": jax.device_get(s.params_depth)},
                {"params": jax.device_get(s.params_sf)})


def _check_epoch(port_trainer, jax_logs, jax_params, epoch):
    hist = [r for r in port_trainer.history if r["epoch"] == epoch]
    assert len(hist) == len(jax_logs) == 1
    assert all(not r["warm"] for r in hist)
    for ours, ref in zip(hist, jax_logs):
        for k in LOG_KEYS:
            np.testing.assert_allclose(ours[k], ref[k], rtol=STEP_RTOL,
                                       err_msg=k)
    step = port_trainer.step
    depth_ref, sf_ref = jax_params
    for (path, a), b in _leaves(step.net_depth, depth_ref):
        np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=str(path))
    # the scene-flow net: PARAM_TOL on SF_SHARE of its weights, and every
    # weight within one Adam step of the JAX one
    sf_step = port_trainer.opt.lr * port_trainer.opt.scene_lr_mul
    outside, total = 0, 0
    for (path, a), b in _leaves(step.net_sf, sf_ref):
        err = np.abs(a - b)
        outside += int((err > PARAM_TOL["atol"]
                        + PARAM_TOL["rtol"] * np.abs(b)).sum())
        total += b.size
        assert err.max() <= sf_step, (path, err.max(), sf_step)
    assert outside <= (1 - SF_SHARE) * total, (outside, total)


def _leaves(net, ref):
    """(path, port value), JAX value for every parameter of ``net``."""
    ours = weights.state_dict_to_flax(net.state_dict(), ref)
    return zip(jax.tree_util.tree_leaves_with_path(ours),
               (np.asarray(b) for b in jax.tree.leaves(ref)))


@pytest.fixture(scope="module")
def boundary(track_root, tmp_path_factory):
    """The port trains the warm-up epoch and resumes into epoch 2; the
    JAX model imports the epoch-1 checkpoint and trains epoch 2."""
    base = tmp_path_factory.mktemp("recipe_runs")
    run = str(base / "run")
    _port(track_root, run, "--epoch", "1")
    ckpt1 = str(base / "ckpt1.pt")
    shutil.copy(os.path.join(run, "checkpoint.pt"), ckpt1)
    resumed = _port(track_root, run, "--epoch", "2", "--resume", "-1")
    side = JaxSide(track_root)
    assert side.load(ckpt1)["epoch"] == 1
    jax_logs = side.train_epoch(2)
    return Namespace(base=base, run=run, ckpt1=ckpt1, resumed=resumed,
                     side=side, jax_logs=jax_logs, jax_params=side.params(),
                     root=track_root)


def test_resume_at_warmup_boundary_matches_jax(boundary):
    ckpt = read_checkpoint(boundary.ckpt1)
    assert ckpt["epoch"] == 1
    assert ckpt["optimizers"][0]["state"] == {}  # the depth Adam is empty
    assert ckpt["optimizers"][1]["state"]
    _check_epoch(boundary.resumed, boundary.jax_logs, boundary.jax_params, 2)


@pytest.fixture(scope="module")
def after(boundary):
    """Epoch 3 from the port's epoch-2 checkpoint: the port resumes, the
    JAX model imports it. Then the JAX state after epoch 3 is exported and
    loaded by a fresh port run with --load_reference_ckpt; both run epoch 4
    from it."""
    from dynamic_video_depth_tpu.runtime.migrate import (
        export_reference_checkpoint)

    ckpt2 = str(boundary.base / "ckpt2.pt")
    shutil.copy(os.path.join(boundary.run, "checkpoint.pt"), ckpt2)
    side = boundary.side
    assert side.load(ckpt2)["epoch"] == 2
    jax_logs = side.train_epoch(3)
    jax_params = side.params()
    resumed = _port(boundary.root, boundary.run, "--epoch", "3",
                    "--resume", "-1")
    exported = str(boundary.base / "exported.pt")
    export_reference_checkpoint(side.model.state, ckpt2, exported,
                                extras={"epoch": 3})
    loaded = _port(boundary.root, str(boundary.base / "loaded"),
                   "--epoch", "4", "--load_reference_ckpt", exported)
    jax_logs_4 = side.train_epoch(4)
    return Namespace(resumed=resumed, jax_logs=jax_logs,
                     jax_params=jax_params, loaded=loaded,
                     jax_logs_4=jax_logs_4, jax_params_4=side.params())


def test_resume_after_warmup_matches_jax(boundary, after):
    ckpt = read_checkpoint(os.path.join(boundary.run, "nets", "0002.pt"))
    assert "optimizers" not in ckpt  # nets/ hold weights only by default
    assert [r["epoch"] for r in after.resumed.history] == [3]
    _check_epoch(after.resumed, after.jax_logs, after.jax_params, 3)


def test_load_reference_ckpt_matches_jax(after):
    """A checkpoint written by the JAX package's exporter loads into the
    port, which continues at the exporter's next epoch as the JAX model
    does."""
    assert [r["epoch"] for r in after.loaded.history] == [4]
    _check_epoch(after.loaded, after.jax_logs_4, after.jax_params_4, 4)


@pytest.fixture(scope="module")
def test_run(boundary, tmp_path_factory):
    """The port's test entry on the boundary run's best.pt, and the JAX
    model at the same weights."""
    out = str(tmp_path_factory.mktemp("recipe_test"))
    summary = test_entry.main(["--checkpoint_path", boundary.run,
                               "--output_dir", out, "--device", "cpu"])
    side = JaxSide(boundary.root)
    side.load(os.path.join(boundary.run, "best.pt"), load_optimizer=False)
    return Namespace(out=out, summary=summary, side=side)


def _jax_frames(side):
    """Per frame: the JAX batch and ``model.test_on_batch``'s output."""
    frames = []
    for i in range(len(side.vali_ds)):
        batch = side.vali_ds[i]
        dev = {k: v for k, v in batch.items() if k != "pair_path"}
        frames.append((batch, side.model.test_on_batch(i, dev)))
    return frames


def test_test_entry_npz_matches_jax(test_run):
    frames = _jax_frames(test_run.side)
    outdir = os.path.join(test_run.out, "epochbest_test")
    npz = sorted(f for f in os.listdir(outdir) if re.match(
        r"batch\d{4}\.npz$", f))
    assert len(npz) == len(frames) == test_run.summary["frames"] == 6
    for name, (batch, pred) in zip(npz, frames):
        ours = dict(np.load(os.path.join(outdir, name)))
        want = {"batch_size": np.asarray([1]), "img_1": batch["img"],
                "img_2": batch["img"], "depth": pred["depth"],
                "sf_1_2": pred["sf_1_2"], "depth_nn": batch["depth_pred"],
                "depth_gt": batch["depth_mvs"], "cam_c2w": batch["cam_c2w"],
                "K": batch["K"], "pair_path": np.asarray(batch["pair_path"])}
        assert sorted(ours) == sorted(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert ours[k].shape == v.shape, k
            if k in ("depth", "sf_1_2"):
                np.testing.assert_allclose(ours[k], v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_test_entry_loss_and_metrics_match_jax(test_run):
    import jax.numpy as jnp

    from dynamic_video_depth_tpu.train.losses import disparity_vali_loss
    from dynamic_video_depth_tpu.utils.metrics import depth_metrics

    frames = _jax_frames(test_run.side)
    loss = np.mean([float(disparity_vali_loss(
        jnp.asarray(p["depth"]), jnp.asarray(b["depth_mvs"])))
        for b, p in frames])
    np.testing.assert_allclose(test_run.summary["disparity_loss"], loss,
                               rtol=1e-5)
    want = depth_metrics(np.stack([p["depth"][0] for _, p in frames]),
                         np.stack([b["depth_mvs"][0] for b, _ in frames]))
    assert sorted(test_run.summary["depth_metrics"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(test_run.summary["depth_metrics"][k], v,
                                   rtol=1e-5, err_msg=k)
    for name in ("epochbest_test.html", "epochbest_test.json"):
        assert os.path.isfile(os.path.join(test_run.out, name))


def test_test_entry_refuses_existing_output(test_run, boundary):
    argv = ["--checkpoint_path", boundary.run, "--output_dir", test_run.out,
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="--overwrite"):
        test_entry.main(argv)


def test_forward_vis_and_pack_output_match_jax(test_run, boundary):
    """The visualization forward of a training pair and its packed dump,
    the port's against the JAX model's at the same weights."""
    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset

    side = test_run.side
    opt = Namespace(**load_opt(boundary.run))
    opt.device = "cpu"
    model = Model(opt, device="cpu", pretrained=False)
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        load_checkpoint)
    load_checkpoint(os.path.join(boundary.run, "best.pt"), model.step)
    ds = Dataset(opt, "train")
    for idx in (0, len(ds) - 1):  # gap 1 and gap 2
        host = ds[idx]
        jbatch = side.train_ds[idx]
        want = side.model.pack_output(
            side.model.vis_on_batch(
                {k: v for k, v in jbatch.items() if k != "pair_path"}),
            jbatch)
        got = model.pack_output(
            model.vis_on_batch(to_device(host, "cpu"), host["steps"]), host)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
