"""The port's train step against the JAX package's, and the port's entry.

Slice parity: the JAX ``SceneFlowMotionFieldStep`` with the tiny depth net
(interpret mode) against the port's step from the same weights, in the
warm-up and the main phase: the logs and both nets' updated parameters.
Two configurations: the per-evaluation Pallas MLP with the full-height
Pallas warp and unfused losses (gaps 1 and 2), and the fully fused path,
the Euler-chain kernel and the fused projection loss with the MiDaS masks
(gaps 1, 2 and 3)."""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from dynamic_video_depth_tpu.train import LossConfig as JaxLossConfig
from dynamic_video_depth_tpu.train import TrainStepConfig as JaxConfig
from dynamic_video_depth_tpu.train.step import SceneFlowMotionFieldStep as JaxStep
from dynamic_video_depth_tpu_torch.models import (HourglassModelEmbed,
                                                  MidasNet)
from dynamic_video_depth_tpu_torch.runtime import weights
from dynamic_video_depth_tpu_torch.train import (LossConfig,
                                                 SceneFlowMotionFieldStep,
                                                 TrainStepConfig)
from dynamic_video_depth_tpu_torch.train import cli
from torch_threads import one_torch_thread  # noqa: F401

LOG_KEYS = ("loss", "flow_loss_1_2", "disp_loss_1_2", "sf_loss", "acc_reg")
NET = dict(lr=1e-4, scene_lr_mul=10.0, depth_net="tiny", net_width=32,
           n_layers=2, n_freq_xyz=4, n_freq_t=2)


def _configs(fused: bool = False):
    """(JAX config, port config): per-evaluation MLP and unfused losses, or
    with ``fused`` the chain and the fused loss with the MiDaS masks."""
    loss = dict(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0, use_disp=True,
                midas=fused)
    mode = "on" if fused else "off"
    jax_cfg = JaxConfig(
        **NET, loss=JaxLossConfig(**loss), compute_dtype="float32",
        use_pallas_sf="on", use_pallas_sf_chain=mode, use_pallas_warp="on",
        pallas_warp_window=None, use_pallas_loss=mode)
    return jax_cfg, TrainStepConfig(**NET, loss=LossConfig(**loss),
                                    use_pallas_sf_chain=mode,
                                    use_pallas_loss=mode)


def _numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), dict(tree))


def _check_step_parity(rng, steps, warm, fused):
    from jax.experimental.pallas import tpu as pltpu

    jax_cfg, cfg = _configs(fused)
    batch = graft._synthetic_batch(1, 16, 24, rng)
    jax_step = JaxStep(jax_cfg)
    state0 = jax_step.init_state(jax.random.PRNGKey(3), batch["img_1"])
    depth0 = {"params": _numpy(state0.params_depth)}
    sf0 = {"params": _numpy(state0.params_sf)}

    step = SceneFlowMotionFieldStep(cfg, device="cpu")
    assert (step.chain_fused, step.loss_fused) == (fused, fused)
    weights.load_flax(step.net_depth, depth0)
    weights.load_flax(step.net_sf, sf0)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    with pltpu.force_tpu_interpret_mode():
        ref_state, ref_logs = jax_step.train_step(
            jax.tree.map(jnp.copy, state0), batch, steps=steps, warm=warm)
    logs = step.train_step(tbatch, steps=steps, warm=warm)

    for k in LOG_KEYS:
        np.testing.assert_allclose(float(logs[k]), float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)
    assert (float(logs["acc_reg"]) == 0.0) == warm
    tol = dict(rtol=1e-4, atol=1e-6)
    for net, ref, init in ((step.net_depth, ref_state.params_depth, depth0),
                           (step.net_sf, ref_state.params_sf, sf0)):
        ours = weights.state_dict_to_flax(net.state_dict(), init)["params"]
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(_numpy(ref))):
            np.testing.assert_allclose(a, b, **tol, err_msg=str(path))
    if warm:  # the depth net is frozen and its Adam group not stepped
        ours = weights.state_dict_to_flax(step.net_depth.state_dict(), depth0)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(depth0)):
            np.testing.assert_array_equal(a, b)
        assert not any(p in step.opt_depth.state
                       for p in step.net_depth.parameters())


@pytest.mark.parametrize("steps,warm", [(1, True), (1, False), (2, True),
                                        (2, False)])
def test_step_matches_jax_step(rng, steps, warm):
    _check_step_parity(rng, steps, warm, fused=False)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("warm", [True, False])
def test_fused_step_matches_jax_fused_step(rng, steps, warm):
    """Kernels C and D's plain versions against the JAX chain and fused
    loss kernels, through the whole step."""
    _check_step_parity(rng, steps, warm, fused=True)


def test_euler_chain_reuses_evaluations():
    """The regularizer's two queries are Euler evaluations 1 and 2; at gap 1
    the second is a phantom evaluation that does not accumulate."""
    _, cfg = _configs()
    step = SceneFlowMotionFieldStep(cfg, device="cpu")
    pts = torch.randn(1, 4, 5, 3, generator=torch.Generator().manual_seed(0))
    ts = torch.zeros(1, 4, 5, 1)
    dt = torch.tensor(0.1)
    with torch.no_grad():
        acc1, f1, s1 = step._sf_multi_step(pts, ts, dt, 1, want_second=True)
        sf0 = step._apply_sf(pts, ts)
        sf1 = step._apply_sf(pts + sf0, ts + dt)
        acc3, f3, s3 = step._sf_multi_step(pts, ts, dt, 3, want_second=True)
    torch.testing.assert_close(acc1, sf0)
    torch.testing.assert_close(f1, sf0)
    torch.testing.assert_close(s1, sf1)
    torch.testing.assert_close(f3, sf0)
    torch.testing.assert_close(s3, sf1)
    assert not torch.allclose(acc3, sf0 + sf1)  # three steps accumulate


CLI_BASE = ["--net", "scene_flow_motion_field", "--dataset",
            "davis_sequence", "--track_id", "dog", "--gaps", "1,2",
            "--epoch", "2", "--epoch_batches", "2", "--warm_sf", "1",
            "--lr", "1e-4", "--scene_lr_mul", "10", "--time_dependent",
            "--use_disp", "--vali_batches", "2", "--batch_size", "1"]
CLI_FLAGS = CLI_BASE + ["--depth_net", "tiny"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("davis"))
    make_track(root, track="dog", n_frames=6, h=32, w=48, gaps=(1, 2))
    return root


def test_cli_trains_on_cpu(fixture_root, tmp_path):
    trainer = cli.main(CLI_FLAGS + ["--data_root", fixture_root,
                                    "--device", "cpu",
                                    "--logdir", str(tmp_path)])
    hist = trainer.history
    assert len(hist) == 4
    assert [r["warm"] for r in hist] == [True, True, False, False]
    for r in hist:
        assert all(np.isfinite(r[k]) for k in LOG_KEYS)
    assert all(r["acc_reg"] == 0.0 for r in hist[:2])
    assert all(r["acc_reg"] > 0.0 for r in hist[2:])


@pytest.mark.parametrize("extra", [["--n_chips", "2"]])
def test_cli_refuses_unported_settings(extra):
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(CLI_FLAGS + ["--device", "cpu"] + extra)


def test_cli_cuda_without_gpu_raises(monkeypatch, fixture_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(CLI_FLAGS + ["--data_root", fixture_root])


@pytest.mark.parametrize("extra,net,masks", [
    ([], "hourglass", False),
    (["--midas"], "midas", True),
    (["--midas", "--depth_net", "hourglass"], "hourglass", False),
    (["--depth_net", "midas"], "midas", True)])
def test_cli_depth_net_follows_midas_flag(extra, net, masks):
    """An explicit --depth_net wins, else --midas decides; the net and the
    loss's MiDaS masks follow the same choice."""
    cfg = cli.step_config(cli.build_parser().parse_args(CLI_BASE + extra))
    assert (cfg.depth_net, cfg.midas, cfg.loss.midas) == (net, masks, masks)
    step = SceneFlowMotionFieldStep(cfg, device="cpu")
    want = MidasNet if net == "midas" else HourglassModelEmbed
    assert type(step.net_depth) is want


@pytest.mark.parametrize("mode,fused", [("auto", False), ("on", True),
                                        ("off", False)])
def test_cli_fused_modes_on_cpu(mode, fused):
    """auto is off on the CPU; on runs the plain versions of the fused
    paths there."""
    opt = cli.build_parser().parse_args(
        CLI_FLAGS + ["--use_pallas_sf_chain", mode, "--use_pallas_loss", mode])
    step = SceneFlowMotionFieldStep(cli.step_config(opt), device="cpu")
    assert (step.chain_fused, step.loss_fused) == (fused, fused)


@pytest.fixture(scope="module")
def midas_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("davis_midas"))
    make_track(root, track="dog", n_frames=5, h=64, w=64, gaps=(1, 2))
    return root


@pytest.fixture
def run_dir(tmp_path):
    """A run directory removed when the test ends. A full-width MiDaS run
    writes ~1.3 GB checkpoints (the net and two optimizer states), which
    pytest would otherwise keep for three sessions: enough, beside the
    parallel workers' files, to fill the disk in the middle of a save."""
    yield str(tmp_path)
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_cli_trains_midas_on_cpu(midas_root, fused, run_dir):
    """--midas at 64x64, 2 epochs x 2 batches, with the fixture's biased
    MiDaS output: the far-field masks keep mass, every loss is finite and
    the main loss is above 0. No per-epoch ``nets/%04d.pt`` (``--save_net
    0``): the test reads no file of the run."""
    from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                            to_device)

    trainer = cli.build_trainer(
        CLI_BASE + ["--midas", "--data_root", midas_root, "--device", "cpu",
                    "--logdir", run_dir, "--save_net", "0",
                    "--use_pallas_sf_chain", fused,
                    "--use_pallas_loss", fused])
    step = trainer.step
    assert type(step.net_depth) is MidasNet and step.cfg.loss.midas
    weights.bias_midas_output(step.net_depth)
    batch = to_device(collate_batches([trainer.dataset_train[0]]), "cpu")
    with torch.no_grad():
        pred, _, _ = step._forward(batch, 1, depth_grad=False)
    occ = (batch["mask_2"] * (pred["depth_1"] < 100.0)
           * (pred["warped_p2_camera_2"][..., 2] < 100.0))
    assert float(occ.sum()) > 0.5 * float(batch["mask_2"].sum())

    hist = trainer.train().history
    assert [r["warm"] for r in hist] == [True, True, False, False]
    for r in hist:
        assert all(np.isfinite(r[k]) for k in LOG_KEYS)
        assert r["loss"] > 0.0
    assert all(r["acc_reg"] > 0.0 for r in hist[2:])
