"""The port's run-time layer against the JAX package's: the loggers fed the
same log stream write the same files and save, stop and warn at the same
points; checkpoints round-trip (full and weights only) in the reference's
torch format; resume paths, option snapshots and the overwrite guard behave
as the JAX train entry's; the pretrained depth files load with the JAX
package's allow-list.
"""

import argparse
import csv
import os

import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch.runtime import checkpoint as ck
from dynamic_video_depth_tpu_torch.runtime import config, loggers, weights
from dynamic_video_depth_tpu_torch.train import cli

import dynamic_video_depth_tpu.runtime.config as jax_config
import dynamic_video_depth_tpu.runtime.loggers as jax_loggers
from torch_threads import one_torch_thread  # noqa: F401

FLAGS = ["--net", "scene_flow_motion_field", "--dataset", "davis_sequence",
         "--track_id", "dog", "--gaps", "1,2", "--epoch_batches", "2",
         "--warm_sf", "1", "--lr", "1e-4", "--scene_lr_mul", "10",
         "--time_dependent", "--use_disp", "--vali_batches", "2",
         "--batch_size", "1", "--depth_net", "tiny", "--manual_seed", "0",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def track_root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("runtime_track"))
    make_track(root, track="dog", n_frames=5, h=32, w=48, gaps=(1, 2))
    return root


# ------------------------------------------------------------------ loggers

def _stream(epochs=3, batches=4, nan_at=None, seed=0):
    """(epoch, [batch logs], epoch-end logs) of a fake run (the reference's
    inline logger smoke, loggers/loggers.py:518-557)."""
    rng = np.random.RandomState(seed)
    out = []
    for epoch in range(1, epochs + 1):
        logs = []
        for b in range(batches):
            loss = (float("nan") if nan_at == (epoch, b)
                    else float(rng.rand()))
            entry = {"size": 1 + b % 2, "loss": loss,
                     "flow_loss_1_2": loss * 0.5, "data_time": 0.01}
            if epoch > 1:  # a metric that appears later
                entry["acc_reg"] = loss * 0.1
            logs.append(entry)
        out.append((epoch, logs, {"loss": 1.0 / epoch, "size": 2,
                                  "epoch_time": 3.0}))
    return out


def _drive(mod, logdir, stream, start_epoch=1, vali_at_start=False):
    """The loggers of a train entry (as the JAX train.py stacks them) fed
    ``stream``; returns the saves the ModelSaveLoggers asked for."""
    saves = []
    cum = mod.LogCumulator()
    best = {"best": float("inf")}
    save = lambda path, epoch=0, best=float("inf"): saves.append(
        (os.path.basename(path), epoch, best))
    logger = mod.ComposeLogger([
        cum, mod.CsvLogger(os.path.join(logdir, "epoch_loss.csv"), cum),
        mod.BatchCsvLogger(os.path.join(logdir, "batch_loss.csv")),
        mod.HtmlLogger(os.path.join(logdir, "html"), cum),
        mod.TerminateOnNaN(),
        mod.ModelSaveLogger(save, os.path.join(logdir, "checkpoint.pt"),
                            period=2, cumulator=cum, best_holder=best),
        mod.ModelSaveLogger(save, os.path.join(logdir, "nets", "%04d.pt"),
                            period=1, cumulator=cum, best_holder=best),
        mod.ModelSaveLogger(save, os.path.join(logdir, "best.pt"),
                            save_best_only=True, cumulator=cum,
                            best_holder=best)])
    logger.set_params({"epochs": len(stream), "steps": 4})
    logger.on_train_begin()
    try:
        if vali_at_start:
            logger.on_epoch_begin(start_epoch - 1)
            logger.on_epoch_end(start_epoch - 1, {"loss": 2.0, "size": 2})
        for epoch, batches, vali in stream:
            logger.on_epoch_begin(epoch)
            for i, logs in enumerate(batches):
                logger.on_batch_end(i, dict(logs))
            logger.on_epoch_end(epoch, dict(vali))
    finally:
        logger.on_train_end()
    return saves


def _files(logdir):
    out = {}
    for name in ("epoch_loss.csv", "batch_loss.csv", "html/progress.json",
                 "html/progress.html"):
        with open(os.path.join(logdir, name)) as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("case", ["plain", "resume", "vali_at_start"])
def test_loggers_match_jax(tmp_path, case):
    """The same stream through both logger stacks: equal CSVs, HTML
    history and save requests; a resumed run appends to the files of the
    first (its new metric merges into the CSV header)."""
    stream = _stream()
    runs = {}
    for name, mod in (("port", loggers), ("jax", jax_loggers)):
        d = str(tmp_path / name)
        if case == "resume":
            saves = _drive(mod, d, stream[:1])
            saves += _drive(mod, d, stream[1:], start_epoch=2)
        else:
            saves = _drive(mod, d, stream,
                           vali_at_start=case == "vali_at_start")
        runs[name] = (saves, _files(d))
    assert runs["port"] == runs["jax"]
    with open(tmp_path / "port" / "epoch_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 + (case == "vali_at_start")
    assert "acc_reg" in rows[-1] and "vali_loss" in rows[-1]


@pytest.mark.parametrize("where,value,stops", [
    ("batch", float("nan"), True), ("batch", float("inf"), False),
    ("epoch", float("nan"), True), ("epoch", float("inf"), False)])
def test_terminate_on_nan_matches_jax(where, value, stops):
    """NaN stops a run at the batch or at the epoch end, inf does not (the
    reference checks isnan only); an epoch's 0-d tensor is checked too."""
    outcomes = []
    for mod in (loggers, jax_loggers):
        guard = mod.ComposeLogger([mod.LogCumulator(), mod.TerminateOnNaN()])
        guard.on_epoch_begin(1)
        try:
            if where == "batch":
                guard.on_batch_end(0, {"size": 1, "loss": value})
            else:
                guard.on_epoch_end(1, {"loss": np.float32(value)})
            outcomes.append(False)
        except FloatingPointError:
            outcomes.append(True)
    assert outcomes == [stops, stops]
    guard = loggers.TerminateOnNaN()
    if stops and where == "epoch":
        with pytest.raises(FloatingPointError):
            guard.on_epoch_end(1, {"loss": torch.tensor(value)})


def test_batch_csv_keeps_rows_up_to_a_nan(tmp_path):
    """A NaN abort leaves the batch CSV up to the failing batch, as the JAX
    logger does."""
    stream = _stream(epochs=2, nan_at=(2, 1))
    texts = []
    for name, mod in (("port", loggers), ("jax", jax_loggers)):
        d = str(tmp_path / name)
        with pytest.raises(FloatingPointError):
            _drive(mod, d, stream)
        with open(os.path.join(d, "batch_loss.csv")) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert len(texts[0].strip().splitlines()) == 1 + 4 + 2


def test_cumulator_matches_jax():
    port, ref = loggers.LogCumulator(), jax_loggers.LogCumulator()
    for cum in (port, ref):
        cum.on_epoch_begin(1)
        cum.on_batch_end(0, {"size": 1, "loss": 1.0})
        cum.on_batch_end(1, {"size": 3, "loss": 2.0, "rare": 10.0})
        cum.on_epoch_end(1, {"loss": 0.5, "size": 4})
    assert port.epoch_logs == ref.epoch_logs
    port.on_epoch_begin(2)
    port.on_batch_end(0, {"size": 1, "loss": torch.tensor(2.5)})
    assert port.get_epoch_logs() == {"loss": 2.5}


def test_tensorboard_missing_warns_once(tmp_path, monkeypatch, capsys):
    """Without the TensorBoard writer: one printed warning, no files, and
    the run goes on."""
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    cum = loggers.LogCumulator()
    tb = loggers.TensorBoardLogger(str(tmp_path / "tb"), cum)
    logger = loggers.ComposeLogger([cum, tb])
    logger.on_train_begin()
    for epoch in (1, 2):
        logger.on_epoch_begin(epoch)
        logger.on_batch_end(0, {"size": 1, "loss": 1.0})
        logger.on_epoch_end(epoch, {})
    logger.on_train_end()
    out = capsys.readouterr().out
    assert out.count("TensorBoard writer unavailable") == 1
    assert not os.path.exists(tmp_path / "tb")


# -------------------------------------------------------------- checkpoints

def _trained_step(seed=0):
    """A tiny-net step after a warm-up and a main step on random data."""
    from dynamic_video_depth_tpu_torch.train import (LossConfig,
                                                     SceneFlowMotionFieldStep,
                                                     TrainStepConfig)

    cfg = TrainStepConfig(lr=1e-4, scene_lr_mul=10.0, depth_net="tiny",
                          net_width=32, n_layers=2, n_freq_xyz=4, n_freq_t=2,
                          loss=LossConfig(use_disp=True))
    step = SceneFlowMotionFieldStep(cfg, device="cpu", seed=seed)
    rng = np.random.RandomState(seed)
    b, h, w = 1, 16, 24
    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    batch = {
        "img_1": rng.rand(b, h, w, 3), "img_2": rng.rand(b, h, w, 3),
        "flow_1_2": rng.randn(b, h, w, 2), "mask_2": np.ones((b, h, w)),
        "R_1": np.eye(3)[None], "R_2": np.eye(3)[None], "K": K[None],
        "K_inv": np.linalg.inv(K)[None], "t_1": np.zeros((b, 3)),
        "t_2": np.full((b, 3), 0.01), "time_stamp_1": np.zeros((b, h, w, 1)),
        "time_step": np.float32(0.1)}
    batch = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in batch.items()}
    for warm in (True, False):
        step.train_step(batch, 1, warm)
    return step


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_round_trip_full(tmp_path):
    step = _trained_step()
    path = str(tmp_path / "checkpoint.pt")
    ck.save_checkpoint(path, step, epoch=4, best=0.25)
    raw = ck.read_checkpoint(path)
    assert sorted(raw) == ["best", "epoch", "nets", "optimizers"]
    fresh = _trained_step(seed=1)
    meta = ck.load_checkpoint(path, fresh)
    assert meta == {"epoch": 4, "best": 0.25}
    for a, b in ((step.net_depth, fresh.net_depth),
                 (step.net_sf, fresh.net_sf)):
        assert _equal(a.state_dict(), b.state_dict())
    for a, b in zip(step.optimizers, fresh.optimizers):
        assert _equal(a.state_dict(), b.state_dict())
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp_")]


def test_checkpoint_round_trip_weights_only(tmp_path):
    step = _trained_step()
    path = str(tmp_path / "0003.pt")
    ck.save_checkpoint(path, step, epoch=3, include_opt=False)
    assert "optimizers" not in ck.read_checkpoint(path)
    fresh = _trained_step(seed=1)
    fresh_opts = [o.state_dict() for o in fresh.optimizers]
    ck.load_checkpoint(path, fresh)
    assert _equal(step.net_sf.state_dict(), fresh.net_sf.state_dict())
    assert _equal(fresh_opts, [o.state_dict() for o in fresh.optimizers])
    with pytest.raises(KeyError):
        ck.load_checkpoint(path, fresh, load_optimizer=True)


@pytest.mark.parametrize("resume,name", [(0, None), (-1, "checkpoint.pt"),
                                         (-2, "best.pt"),
                                         (7, "nets/0007.pt")])
def test_resolve_resume(tmp_path, resume, name):
    from dynamic_video_depth_tpu.runtime.checkpoint import (
        resolve_resume as jax_resolve)

    got = ck.resolve_resume(str(tmp_path), resume)
    assert got == (None if name is None else str(tmp_path / name))
    want = jax_resolve(str(tmp_path), resume)
    assert (got is None) == (want is None)
    if got is not None:  # the JAX files are .ckpt, the reference's .pt
        assert os.path.splitext(got)[0] == os.path.splitext(want)[0]


def test_opt_round_trip_and_resume_overwrite(tmp_path):
    opt = argparse.Namespace(lr=1e-6, gaps="1,2", midas=True, epoch=5,
                             device="cpu", test_template="t.txt")
    ck.save_opt(str(tmp_path), opt)
    saved = ck.load_opt(str(tmp_path))
    assert saved == vars(opt)
    assert os.path.isfile(tmp_path / "opt.txt")
    now = argparse.Namespace(lr=1.0, gaps="1", midas=False, epoch=9,
                             device="cuda", test_template=None)
    config.overwrite(now, saved)
    assert (now.lr, now.gaps, now.midas) == (1e-6, "1,2", True)
    assert (now.epoch, now.device, now.test_template) == (9, "cuda", None)


@pytest.mark.parametrize("flags", [
    [], ["--suffix", "track_{track_id}_lr{lr}"], ["--exprdir_no_prefix",
                                                  "--suffix", "x{gaps}"]])
def test_exprdir_and_tensorboard_dir_match_jax(flags):
    opt = cli.build_parser().parse_args(FLAGS + flags)
    assert config.exprdir_name(opt) == jax_config.exprdir_name(opt)
    for logdir, kw in (("/a/checkpoints/b/c", "checkpoints"),
                       ("/a/runs/b", "checkpoints"), ("/a/b", "none")):
        opt.full_logdir, opt.tensorboard_keyword = logdir, kw
        assert config.tensorboard_logdir(opt, "e") == \
            jax_config.tensorboard_logdir(opt, "e")


def test_unique_params_are_the_jax_set():
    """The JAX set less its TPU-only names and the flags the port lacks,
    plus the torch device (the pipeline's ``--workers``, ``--profile_dir``
    and ``--no_device_cache`` are shared)."""
    parser = argparse.ArgumentParser()
    _, jax_unique = jax_config.add_general_arguments(parser)
    tpu_only = {"gpu", "steps_per_dispatch", "remat_depth"}
    assert config.UNIQUE_PARAMS == (jax_unique - tpu_only) | {"device"}


# --------------------------------------------------------------- the entry

def _run_flags(root, logdir, *extra):
    return FLAGS + ["--data_root", root, "--full_logdir", str(logdir)] + \
        list(extra)


def test_fresh_run_refuses_an_existing_run(tmp_path, track_root):
    cli.main(_run_flags(track_root, tmp_path / "run", "--epoch", "1"))
    with pytest.raises(SystemExit, match="--force_overwrite"):
        cli.build_run(_run_flags(track_root, tmp_path / "run", "--epoch",
                                 "1"))
    (tmp_path / "run" / "marker").write_text("old run")
    run = cli.build_run(_run_flags(track_root, tmp_path / "run", "--epoch",
                                   "1", "--force_overwrite"))
    assert not (tmp_path / "run" / "marker").exists()
    assert run.start_epoch == 1


def test_resume_loads_checkpoint_bit_for_bit(tmp_path, track_root):
    """--resume -1: both nets and both Adams equal checkpoint.pt, the run
    continues at the next epoch with the saved options and the best value
    of best.pt."""
    run_dir = tmp_path / "run"
    cli.main(_run_flags(track_root, run_dir, "--epoch", "2"))
    saved = ck.read_checkpoint(str(run_dir / "checkpoint.pt"))
    run = cli.build_run(["--full_logdir", str(run_dir), "--resume", "-1",
                         "--epoch", "3", "--device", "cpu",
                         "--batch_size", "1", "--epoch_batches", "2",
                         "--vali_batches", "2"])
    step = run.model.step
    assert run.start_epoch == 3 and saved["epoch"] == 2
    assert _equal([step.net_depth.state_dict(), step.net_sf.state_dict()],
                  saved["nets"])
    assert _equal([o.state_dict() for o in step.optimizers],
                  saved["optimizers"])
    assert run.opt.depth_net == "tiny" and run.opt.gaps == "1,2"
    assert run.best_holder["best"] == ck.read_best(str(run_dir / "best.pt"))
    trainer = run.train()
    assert {r["epoch"] for r in trainer.history} == {3}


def test_save_every_and_save_net_opt(tmp_path, track_root):
    """--save_every 2 over 3 epochs still ends with a checkpoint of epoch 3;
    --save_net_opt keeps the Adams in nets/%04d.pt."""
    run_dir = tmp_path / "run"
    run = cli.build_run(_run_flags(track_root, run_dir, "--epoch", "3",
                                   "--save_every", "2", "--save_net_opt"))
    run.train()
    saved = [os.path.relpath(p, run_dir) for p, *_ in run.saves
             if not p.endswith("best.pt")]
    assert saved == ["nets/0001.pt", "checkpoint.pt", "nets/0002.pt",
                     "nets/0003.pt", "checkpoint.pt"]
    assert ck.read_checkpoint(str(run_dir / "checkpoint.pt"))["epoch"] == 3
    for e in (1, 2, 3):
        net = ck.read_checkpoint(str(run_dir / "nets" / f"{e:04d}.pt"))
        assert net["epoch"] == e and "optimizers" in net


def test_run_writes_the_loggers_and_visualization(tmp_path, track_root):
    run_dir = tmp_path / "run"
    cli.main(_run_flags(track_root, run_dir, "--epoch", "2", "--log_batch",
                        "--html_logger", "--vis_batches_train", "1",
                        "--vis_batches_vali", "1", "--vali_at_start"))
    with open(run_dir / "epoch_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    with open(run_dir / "batch_loss.csv") as f:
        assert len(list(csv.DictReader(f))) == 4
    assert (run_dir / "html" / "progress.html").is_file()
    for e in (1, 2):
        train = run_dir / "visualize" / f"epoch{e:04d}_train"
        vali = run_dir / "visualize" / f"epoch{e:04d}_vali"
        assert (train / "rank0000_batch0001.npz").is_file()
        assert (vali / "rank0000_batch0000.npz").is_file()
        assert (train / "index.html").is_file()
        assert (vali / f"batch{1000 * e:04d}_depth.png").is_file()
        assert (train / f"batch{1000 * e + 1:04d}_depth_1.png").is_file()
        npz = np.load(train / "rank0000_batch0001.npz")
        assert "sf_loss_pp" in npz and npz["depth_1"].shape == (1, 32, 48)


def test_test_entry_cuda_without_gpu_raises(monkeypatch):
    from dynamic_video_depth_tpu_torch import test as test_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_entry.main(["--checkpoint_path", "run", "--output_dir", "out"])


def test_test_entry_refuses_n_chips(monkeypatch):
    """``--n_chips`` beyond the cards there are is refused before anything
    is read (the frames at ``--n_chips`` 2 and 3 are
    ``tests/test_torch_fleet.py``'s)."""
    from dynamic_video_depth_tpu_torch import test as test_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="n_chips 2 needs 2 CUDA devices"):
        test_entry.main(["--checkpoint_path", "run", "--output_dir", "out",
                         "--device", "cuda", "--n_chips", "2"])


# -------------------------------------------------------- pretrained depth

def _leftover(sd, key):
    out = dict(sd)
    out[key] = torch.zeros(2)
    return out


@pytest.mark.parametrize("extra,ok", [
    (None, True), ("num_batches_seen", True),
    ("net_depth.uncertainty_layer.0.weight", True),
    ("net_depth.stray.weight", False)])
def test_pretrained_hourglass_loads_with_the_allow_list(tmp_path, extra, ok):
    """The hourglass file holds the inner net's keys; the JAX allow-list's
    leftovers are skipped and any other leftover raises."""
    from dynamic_video_depth_tpu_torch.models import HourglassModelEmbed

    src = HourglassModelEmbed(generator=torch.Generator().manual_seed(1))
    sd = {k.removeprefix("net_depth."): v
          for k, v in src.state_dict().items()}
    if extra:
        sd = _leftover(sd, extra.removeprefix("net_depth."))
    path = str(tmp_path / "hourglass.pth")
    torch.save(sd, path)
    net = HourglassModelEmbed(generator=torch.Generator().manual_seed(2))
    if not ok:
        with pytest.raises(KeyError, match="not consumed"):
            weights.load_pretrained_depth(net, path, midas=False)
        return
    weights.load_pretrained_depth(net, path, midas=False)
    assert _equal(net.state_dict(), src.state_dict())


def test_model_loads_the_pretrained_file_or_warns(tmp_path, monkeypatch,
                                                  capsys):
    from dynamic_video_depth_tpu_torch.models import HourglassModelEmbed
    from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import (
        Model)

    opt = cli.build_parser().parse_args(FLAGS + ["--depth_net", "hourglass"])
    monkeypatch.setattr(weights, "DEPTH_PRETRAIN_PATH",
                        str(tmp_path / "absent.pth"))
    model = Model(opt, device="cpu")
    assert not model.used_pretrained
    assert "not found; using random init" in capsys.readouterr().out
    src = HourglassModelEmbed(generator=torch.Generator().manual_seed(5))
    path = tmp_path / "hourglass.pth"
    torch.save({k.removeprefix("net_depth."): v
                for k, v in src.state_dict().items()}, path)
    monkeypatch.setattr(weights, "DEPTH_PRETRAIN_PATH", str(path))
    model = Model(opt, device="cpu")
    assert model.used_pretrained
    assert _equal(model.step.net_depth.state_dict(), src.state_dict())
    counts = model.count_params()
    assert counts["net_depth"] == sum(p.numel() for p in src.parameters())
