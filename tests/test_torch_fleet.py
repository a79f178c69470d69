"""The port's fleet entry, the test entry's and preprocessing's
``--n_chips``, on the CPU (gloo ranks, ``--device cpu``).

- ``python -m dynamic_video_depth_tpu_torch.train.fleet`` on two synthetic
  tracks at ``--dp 1`` (one video per rank) and at ``--dp 2`` (each
  video's batch of 2 over two ranks), two epochs of three steps with a
  warm-up epoch: the per-track and fleet artifacts, and each video's step
  losses, validation losses and final nets against a one-process replay of
  the fleet's draws with the port's step. The first step, before any
  update, agrees at ``FIRST_RTOL`` (float32 rounding of the split batch's
  sums at ``--dp 2``); later steps and the validation losses at
  ``JAX_MAIN_RTOL``: after an Adam update, points within roundoff of a
  leaky-relu kink take other slopes in two float32 computations, and the
  replay runs in the test's process, whose earlier tests may leave other
  kernels in use than a fresh rank's (measured in a fresh process: 0 at
  ``--dp 1``, up to 4.2e-5 at ``--dp 2``; in a loaded run of the suite
  1.5e-4 in the warm-up epoch). Each net's final weights: at least
  ``MIN_SHARE`` of them within ``WEIGHT_TOL`` of the replay's (the
  parameter tolerance of ``test_torch_parallel.py``), and the untrained
  nets below that share. Measured on these tracks: 1.0 (both nets) at
  ``--dp 1`` and at least 0.985 at ``--dp 2`` in a fresh process; with
  the replay at another thread count than the ranks' (other kernels), as
  low as 0.67 (the field); replays of another video's draws or of only the
  first rank's pairs at ``--dp 2`` (a missing gradient all-reduce): at
  most 0.29 (depth) and 0.006 (field); the untrained nets at most 0.15
  and 0.0044.
- The same fleets against the JAX package's ``train_fleet.py`` run as a
  subprocess (``DVD_PLATFORM=cpu``, virtual devices) from the port's
  initial weights: the fleet's ``epoch_loss.csv`` rows and each track's
  ``vali_loss.csv``. The warm-up epoch's rows and the validation losses
  agree at ``rtol 1e-4``; the main epoch's rows, three Adam steps later,
  at ``rtol 1e-3`` (leaky-relu slope flips of the full-width scene-flow MLP
  part the two float32 runs by about 1e-4 there, as
  ``test_torch_recipe.py`` describes).
- ``--resume -1`` on the two-video fleet: each track's ``checkpoint.pt``
  restored bit for bit (a resumed run with nothing left to train
  re-validates with ``--vali_at_start`` and saves the same nets and
  optimizer states).
- The refusals: ``--batch_size`` not a multiple of ``--dp``, a layout
  larger than the cards, ``--steps_per_dispatch 2``.
- A non-finite loss stops the fleet.
- The test entry at ``--n_chips 2`` and ``3`` (five frames, so the last
  group is padded) against ``--n_chips 1``, and preprocessing at
  ``--n_chips 2`` against a serial run (three raw frames, so both stages
  pad), file for file and bit for bit.
"""

import argparse
import os
import shutil
import subprocess
import sys
from os.path import join

import numpy as np
import pytest
import torch

from dynamic_video_depth_tpu_torch import test as test_entry
from dynamic_video_depth_tpu_torch.data import get_dataset
from dynamic_video_depth_tpu_torch.data.batches import (collate_batches,
                                                        to_device)
from dynamic_video_depth_tpu_torch.runtime.checkpoint import read_checkpoint
from dynamic_video_depth_tpu_torch.train import cli, fleet
from dynamic_video_depth_tpu_torch.train.loop import LOG_KEYS, group_by_gap
from dynamic_video_depth_tpu_torch.train.scene_flow_motion_field import Model
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKS = ("dog", "cat")
FLAGS = ["--depth_net", "tiny", "--gaps", "1,2", "--epoch", "2",
         "--warm_sf", "1", "--epoch_batches", "3", "--vali_batches", "2",
         "--manual_seed", "0", "--time_dependent", "--use_disp", "--lr",
         "1e-4", "--scene_lr_mul", "10"]
JAX_WARM_RTOL, JAX_MAIN_RTOL, FIRST_RTOL = 1e-4, 1e-3, 1e-5
WEIGHT_TOL, MIN_SHARE = dict(rtol=1e-4, atol=1e-6), 0.5

# the JAX fleet entry from the port's initial weights: its model's init is
# followed by an import of the port's reference-format checkpoint
JAX_WRAPPER = """
import runpy, sys
ckpt, script = sys.argv[1], sys.argv[2]
from dynamic_video_depth_tpu.runtime.migrate import import_reference_checkpoint
from dynamic_video_depth_tpu.train.scene_flow_motion_field import Model
init = Model.init_from_sample
def init_from_port(self, img, seed=0):
    init(self, img, seed=seed)
    self.state, _ = import_reference_checkpoint(
        ckpt, self.step, self.state, load_optimizer=False)
Model.init_from_sample = init_from_port
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from dynamic_video_depth_tpu_torch.data.synthetic import make_track

    root = str(tmp_path_factory.mktemp("fleet_tracks"))
    for i, t in enumerate(TRACKS):
        make_track(root, track=t, n_frames=5, h=32, w=48, gaps=(1, 2),
                   seed=i)
    return root


def _fleet(root, logdir, tracks, *extra):
    return fleet.main(["--tracks", ",".join(tracks), "--device", "cpu",
                       "--data_root", root, "--logdir", logdir] + FLAGS
                      + list(extra))


def _share(ours, want):
    """The share of a state dict's elements within ``WEIGHT_TOL`` of
    ``want``'s."""
    within = total = 0
    for k, w in want.items():
        close = torch.isclose(ours[k], w, **WEIGHT_TOL)
        within, total = within + int(close.sum()), total + close.numel()
    return within / total


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [dict(zip(header, map(float, line.split(","))))
                for line in f if line.strip()]
    return rows


class Replay:
    """The fleet's draws replayed in one process: one port step per video
    at the whole batch (JAX train_fleet.py's algorithm, written out
    here)."""

    def __init__(self, root, tracks, dp, batch_size):
        opt = fleet.build_parser().parse_args(
            ["--tracks", ",".join(tracks), "--data_root", root,
             "--device", "cpu", "--batch_size", str(batch_size)] + FLAGS)
        self.opt, self.dp = opt, dp
        self.train, self.vali, self.steps = [], [], []
        for t in tracks:
            o = argparse.Namespace(**vars(opt))
            o.track_id = t
            self.train.append(get_dataset("davis_sequence")(o, "train"))
            self.vali.append(get_dataset("davis_sequence")(o, "vali"))
            self.steps.append(Model(o, device="cpu", seed=0).step)

    def run(self, threads):
        torch.set_num_threads(threads)
        opt, n_videos = self.opt, len(self.train)
        orders = [group_by_gap(ds) for ds in self.train]
        gaps = sorted(set.intersection(*[set(o) for o in orders]))
        counts = np.array([sum(len(o[g]) for o in orders) for g in gaps],
                          np.float64)
        rng = np.random.RandomState(0)
        logs = [[] for _ in range(n_videos)]
        vali = [[] for _ in range(n_videos)]
        for epoch in (1, 2):
            for _ in range(opt.epoch_batches):
                gap = gaps[rng.choice(len(gaps), p=counts / counts.sum())]
                per = opt.batch_size if self.dp > 1 else 1
                draws = [[orders[v][gap][rng.randint(len(orders[v][gap]))]
                          for _ in range(per)] for v in range(n_videos)]
                for v in range(n_videos):
                    host = collate_batches([self.train[v][j]
                                            for j in draws[v]])
                    out = self.steps[v].train_step(
                        to_device(host, "cpu"), host["steps"], epoch <= 1)
                    logs[v].append({k: float(out[k]) for k in LOG_KEYS})
            for v in range(n_videos):
                loss = np.zeros(1)
                for fi in range(opt.vali_batches):
                    _, out = self.steps[v].vali_step(
                        to_device(self.vali[v][fi], "cpu"))
                    loss += np.asarray([float(out["loss"])], np.float32) / \
                        opt.vali_batches
                vali[v].append(float(loss[0]))
        return logs, vali


@pytest.fixture(scope="module", params=[1, 2], ids=["dp1", "dp2"])
def fleet_run(request, root, tmp_path_factory):
    """The entry on both tracks at ``--dp 1`` (two ranks) or ``--dp 2``
    (four), and its replay."""
    dp = request.param
    tracks = TRACKS
    flags = ["--dp", str(dp), "--batch_size", str(dp)]
    logdir = str(tmp_path_factory.mktemp(f"fleet_dp{dp}"))
    out = _fleet(root, logdir, tracks, *flags)
    replay = Replay(root, tracks, dp, dp)
    untrained = [[{k: v.clone() for k, v in net.state_dict().items()}
                  for net in (s.net_depth, s.net_sf)] for s in replay.steps]
    threads = torch.get_num_threads()
    try:  # the ranks' thread count (train/fleet.py::_rank_main)
        logs, vali = replay.run(max(1, (os.cpu_count() or 1)
                                    // (len(tracks) * dp)))
    finally:
        torch.set_num_threads(threads)
    return argparse.Namespace(dp=dp, tracks=tracks, flags=flags, root=root,
                              logdir=logdir, out=out, replay=replay,
                              logs=logs, vali=vali, untrained=untrained)


def test_fleet_entry_writes_the_artifacts(fleet_run):
    logdir = fleet_run.logdir
    for f in ("epoch_loss.csv", "opt.json", "fleet_rank0.json",
              "fleet_rank1.json"):
        assert os.path.isfile(join(logdir, f)), f
    for t in fleet_run.tracks:
        for f in ("vali_loss.csv", "checkpoint.pt", "best.pt"):
            assert os.path.isfile(join(logdir, t, f)), (t, f)
        ckpt = read_checkpoint(join(logdir, t, "checkpoint.pt"))
        assert ckpt["epoch"] == 2 and len(ckpt["optimizers"]) == 2
    rows = _read_csv(join(logdir, "epoch_loss.csv"))
    assert [r["epoch"] for r in rows] == [1, 2]
    assert rows[0]["acc_reg"] == 0 and rows[1]["acc_reg"] > 0
    ranks = fleet_run.out["ranks"]
    n = len(TRACKS) * fleet_run.dp
    assert [r["rank"] for r in ranks] == list(range(n))
    assert [r["video"] for r in ranks] == [i // fleet_run.dp
                                           for i in range(n)]
    assert all(r["backend"] == "gloo" and len(r["step_ms"]) == 6
               for r in ranks)


def test_fleet_entry_matches_a_one_process_replay(fleet_run):
    ranks = fleet_run.out["ranks"]
    for r in ranks:
        v = r["video"]
        assert len(r["records"]) == len(fleet_run.logs[v]) == 6
        for i, (ours, want) in enumerate(zip(r["records"],
                                             fleet_run.logs[v])):
            assert ours["warm"] == (i < 3)
            rtol = FIRST_RTOL if i == 0 else JAX_MAIN_RTOL
            for k in LOG_KEYS:
                np.testing.assert_allclose(ours[k], want[k], rtol=rtol,
                                           err_msg=k)
    for v, t in enumerate(fleet_run.tracks):
        rows = _read_csv(join(fleet_run.logdir, t, "vali_loss.csv"))
        np.testing.assert_allclose([r["vali_loss"] for r in rows],
                                   fleet_run.vali[v], rtol=JAX_MAIN_RTOL)
        nets = read_checkpoint(join(fleet_run.logdir, t,
                                    "checkpoint.pt"))["nets"]
        step = fleet_run.replay.steps[v]
        for name, sd, net, untrained in zip(
                ("depth", "field"), nets, (step.net_depth, step.net_sf),
                fleet_run.untrained[v]):
            want = net.state_dict()
            assert _share(sd, want) >= MIN_SHARE, (t, name)
            assert _share(untrained, want) < MIN_SHARE, (t, name)
    if fleet_run.dp == 2:  # the ranks of a video logged the same batch
        drop = lambda recs: [{k: v for k, v in r.items() if k != "ms"}
                             for r in recs]
        for a, b in ((0, 1), (2, 3)):
            assert drop(ranks[a]["records"]) == drop(ranks[b]["records"])


@pytest.mark.parametrize("fleet_run", [1], indirect=True, ids=["dp1"])
def test_fleet_resume_restores_each_track_bit_for_bit(fleet_run, tmp_path,
                                                      capfd):
    logdir = str(tmp_path / "run")
    shutil.copytree(fleet_run.logdir, logdir)
    _fleet(fleet_run.root, logdir, fleet_run.tracks, "--resume", "-1",
           "--vali_at_start", *fleet_run.flags)
    assert "Resumed fleet at epoch 2" in capfd.readouterr().out
    for t in fleet_run.tracks:
        before = read_checkpoint(join(fleet_run.logdir, t, "checkpoint.pt"))
        after = read_checkpoint(join(logdir, t, "checkpoint.pt"))
        # the best validation loss restored from best.pt (checkpoint.pt's
        # own is the best before its epoch, as the JAX fleet writes it)
        best = read_checkpoint(join(fleet_run.logdir, t, "best.pt"))["best"]
        assert after["epoch"] == 2 and after["best"] == best
        for a, b in zip(before["nets"], after["nets"]):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(before["optimizers"], after["optimizers"]):
            for p, sa in a["state"].items():
                sb = b["state"][p]
                assert all(torch.equal(sa[k], sb[k]) for k in sa)
        rows = _read_csv(join(logdir, t, "vali_loss.csv"))
        assert [r["epoch"] for r in rows] == [1, 2, 2]
        assert rows[1]["vali_loss"] == rows[2]["vali_loss"]


@pytest.mark.parametrize("extra,error,match", [
    (["--dp", "2", "--batch_size", "3"], SystemExit,
     "must be a multiple of --dp 2"),
    (["--steps_per_dispatch", "2"], NotImplementedError, "not ported"),
], ids=["batch_size", "steps_per_dispatch"])
def test_fleet_entry_refuses(root, tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        _fleet(root, str(tmp_path), TRACKS, *extra)
    assert not os.listdir(tmp_path)


def test_fleet_entry_stops_on_a_non_finite_loss(root, tmp_path):
    """Adam at lr 1e30 moves every weight by 1e30 in the first step, and
    a later step's loss is not finite: the fleet's all-reduced count of
    non-finite losses stops it."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="a non-finite loss in the fleet"):
        _fleet(root, str(tmp_path), TRACKS, "--lr", "1e30")


def test_fleet_entry_refuses_a_layout_larger_than_the_cards(
        root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 CUDA devices, have 1"):
        fleet.main(["--tracks", "dog,cat", "--data_root", root,
                    "--logdir", str(tmp_path)] + FLAGS)


def test_train_entry_names_the_fleet_for_n_chips():
    with pytest.raises(NotImplementedError,
                       match="train.fleet --tracks T --dp N"):
        cli.main(FLAGS + ["--device", "cpu", "--n_chips", "2"])


def test_fleet_entry_matches_jax_fleet(fleet_run, tmp_path):
    """The JAX entry on the same two tracks with 2 x ``dp`` virtual
    devices, from the port's initial weights."""
    from dynamic_video_depth_tpu_torch.runtime.checkpoint import (
        save_checkpoint)

    ours, dp = fleet_run.logdir, fleet_run.dp
    opt = fleet.build_parser().parse_args(
        ["--tracks", ",".join(TRACKS), "--data_root", fleet_run.root,
         "--device", "cpu"] + FLAGS)
    init = str(tmp_path / "init.pt")
    save_checkpoint(init, Model(opt, device="cpu", seed=0).step,
                    include_opt=False)
    wrapper = str(tmp_path / "jax_fleet.py")
    with open(wrapper, "w") as f:
        f.write(JAX_WRAPPER)
    theirs = str(tmp_path / "jax")
    env = dict(os.environ, DVD_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={2 * dp}")
    proc = subprocess.run(
        [sys.executable, wrapper, init, join(REPO, "train_fleet.py"),
         "--tracks", ",".join(TRACKS), "--net", "scene_flow_motion_field",
         "--dataset", "davis_sequence", "--data_root", fleet_run.root,
         "--logdir", theirs] + FLAGS + fleet_run.flags,
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = _read_csv(join(ours, "epoch_loss.csv"))
    ref = _read_csv(join(theirs, "epoch_loss.csv"))
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in ref] == [1, 2]
    for ours_row, ref_row, rtol in zip(rows, ref,
                                       (JAX_WARM_RTOL, JAX_MAIN_RTOL)):
        assert set(ours_row) == set(ref_row)
        for k in ref_row:
            np.testing.assert_allclose(ours_row[k], ref_row[k], rtol=rtol,
                                       err_msg=k)
    for t in TRACKS:
        a = _read_csv(join(ours, t, "vali_loss.csv"))
        b = _read_csv(join(theirs, t, "vali_loss.csv"))
        assert [r["epoch"] for r in a] == [r["epoch"] for r in b]
        np.testing.assert_allclose([r["vali_loss"] for r in a],
                                   [r["vali_loss"] for r in b],
                                   rtol=JAX_WARM_RTOL)


@pytest.fixture(scope="module")
def one_chip(root, tmp_path_factory):
    """A single-video run of one epoch on a five-frame track, and the test
    entry's output on it at ``--n_chips 1``."""
    run = str(tmp_path_factory.mktemp("test_run"))
    cli.main(FLAGS + ["--data_root", root, "--track_id", "dog",
                      "--device", "cpu", "--full_logdir", run, "--epoch",
                      "1", "--batch_size", "1"])
    return run, _test_entry(run, str(tmp_path_factory.mktemp("n1")), 1)


def _test_entry(run, out, n_chips):
    summary = test_entry.main(["--checkpoint_path", run, "--output_dir", out,
                               "--device", "cpu", "--n_chips", str(n_chips)])
    assert summary["frames"] == 5 and summary["n_chips"] == n_chips
    return summary, _npz_dir(join(out, "epochbest_test"))


def _npz_dir(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(join(path, name)) as f:
                out[name] = {k: f[k] for k in f.files}
    return out


def _assert_same_npz(a, b):
    assert a.keys() == b.keys() and a
    for name in a:
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k],
                                          err_msg=f"{name}:{k}")


@pytest.mark.parametrize("n_chips", [2, 3])
def test_test_entry_n_chips_matches_one_chip(one_chip, tmp_path, n_chips):
    run, (summary, npz) = one_chip
    ours, ours_npz = _test_entry(run, str(tmp_path), n_chips)
    assert len(npz) == 5
    _assert_same_npz(npz, ours_npz)
    assert ours["disparity_loss"] == summary["disparity_loss"]
    assert ours["depth_metrics"] == summary["depth_metrics"]


def test_preprocessing_n_chips_matches_serial(tmp_path, monkeypatch):
    """Stages 1-3 on three raw frames at 64x96 (RAFT at 64x96, 2
    iterations), serial and at ``--n_chips 2``: stage 1's batch of three
    pads to four, stage 2's last batch of one pair to two."""
    from test_torch_preprocess import small_raft

    from dynamic_video_depth_tpu_torch.data.synthetic import write_raw_davis
    from dynamic_video_depth_tpu_torch.preprocess import run_davis

    raw = str(tmp_path / "raw")
    write_raw_davis(raw, "dog", n_frames=3)
    small_raft(monkeypatch)
    outs = {}
    for n in ("0", "2"):
        out = str(tmp_path / f"out{n}")
        run_davis.main(["--raw_root", raw, "--track", "dog", "--out_root",
                        out, "--gaps", "1,2", "--raft_ckpt",
                        str(tmp_path / "none"), "--device", "cpu",
                        "--n_chips", n])
        outs[n] = [_npz_dir(join(out, d, "dog"))
                   for d in ("frames_midas", "flow_pairs")]
    assert len(outs["0"][0]) == 3 and len(outs["0"][1]) == 2 + 1
    for a, b in zip(outs["0"], outs["2"]):
        _assert_same_npz(a, b)
