"""The port's ShutterStock preprocessing against the JAX package's
``scripts/preprocess/run_shutterstock.py``: ``get_im_size`` over a grid of
frame shapes, stage 1 from per-frame h5 files (written with ``h5py`` here)
against ``process_track_h5`` with the same stand-in depth function, and the
entry's stages 1-3 on the CPU into packed pairs that load through
``--dataset shutterstock``. ``h5py`` is imported only inside the h5
reader. Inputs come from numpy with a seed."""

import argparse
import os
import subprocess
import sys
from os.path import dirname, join

import numpy as np
import pytest

from dynamic_video_depth_tpu_torch.preprocess import flows, run_shutterstock

REPO = dirname(dirname(os.path.abspath(__file__)))
FRAME_KEYS = ("img", "pose_c2w", "intrinsics", "depth_pred", "depth_mvs",
              "img_orig")


def _jax_script():
    sys.path.insert(0, join(REPO, "scripts", "preprocess"))
    import run_shutterstock as jax_script

    return jax_script


def stand_in_depth(imgs):
    """A smooth positive depth of the image, in place of MiDaS."""
    return 2.0 + np.asarray(imgs).mean(-1)


def write_h5_track(raw, n, h, w, seed=0):
    """``n`` per-frame h5 files ``frame_<i>.h5`` in the layout the reader
    takes: the MVS depth is half the stand-in depth (scale 2), a camera
    translating along x."""
    import h5py

    rng = np.random.RandomState(seed)
    os.makedirs(raw, exist_ok=True)
    files = []
    for i in range(n):
        p = join(raw, f"frame_{i}.h5")
        img = rng.rand(h, w, 3).astype(np.float32)
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.02 * i, 0.05]
        with h5py.File(p, "w") as hf:
            g = hf.create_group("prediction")
            g["img"] = img
            mvs = stand_in_depth(img[None])[0] / 2.0
            mvs[: h // 4] = 0.0  # invalid MVS depth where it is 0
            g["mvs_depth"] = mvs.astype(np.float32)
            g["T_1_G"] = T
            g["K"] = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2],
                               [0, 0, 1]], np.float32)
        files.append(p)
    return files


@pytest.mark.parametrize("h,w", [(40, 64), (64, 40), (432, 768), (768, 432),
                                 (1080, 1920), (100, 100), (383, 385),
                                 (33, 31), (720, 1280), (384, 384)])
def test_get_im_size_matches_jax(h, w):
    th, tw = run_shutterstock.get_im_size(h, w)
    assert (th, tw) == _jax_script().get_im_size(h, w)
    assert th % 32 == 0 and tw % 32 == 0


@pytest.mark.parametrize("h,w,want", [(224, 384, None), (432, 768, (448, 768)),
                                      (40, 64, (64, 64)), (720, 1280, (736, 1280))])
def test_midas_input_size(h, w, want):
    assert run_shutterstock.midas_input_size(h, w) == want


def test_stage1_from_h5_matches_jax(tmp_path):
    """The same npz files as ``process_track_h5``: every key, shape and
    dtype, the values at the stage-1 tolerance of the DAVIS stage-1 test
    (rtol 1e-5, atol 1e-6: the port's float32 bilinear resize against the
    JAX package's)."""
    files = write_h5_track(str(tmp_path / "raw"), n=3, h=40, w=64)
    ref_dir, our_dir = str(tmp_path / "ref"), str(tmp_path / "ours")
    s_ref = _jax_script().process_track_h5(files, ref_dir, stand_in_depth)
    imgs, mvs, t_1_g, K = run_shutterstock.load_shutterstock_h5(files)
    assert t_1_g.dtype == np.float64 and K.dtype == np.float32
    s = run_shutterstock.process_shutterstock_track(imgs, mvs, t_1_g, K,
                                                    our_dir, stand_in_depth)
    np.testing.assert_allclose(s, 2.0, rtol=1e-5)
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(our_dir)) == [
        f"frame_{i:05d}.npz" for i in range(3)]
    for name in names:
        with np.load(join(our_dir, name)) as a, \
                np.load(join(ref_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files) == sorted(FRAME_KEYS)
            for k in FRAME_KEYS:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name}:{k}")
    with np.load(join(our_dir, names[0])) as d:
        assert d["img"].shape == (32, 64, 3)


def test_reader_alone_imports_h5py():
    """Importing the entry, the pipeline and the profiler pulls in neither
    ``h5py`` nor JAX."""
    code = ("import sys\n"
            "import dynamic_video_depth_tpu_torch.preprocess.run_shutterstock\n"
            "import dynamic_video_depth_tpu_torch.data.prefetch\n"
            "import dynamic_video_depth_tpu_torch.data.base\n"
            "import dynamic_video_depth_tpu_torch.runtime.profiling\n"
            "bad = [m for m in sys.modules if m in ('h5py', 'jax') or "
            "m.startswith('dynamic_video_depth_tpu.')]\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert "BAD []" in out


def test_entry_runs_stages_1_to_3_into_the_shutterstock_reader(
        tmp_path, monkeypatch, capsys):
    """The entry on the CPU: MiDaS with random weights on four 64x96 h5
    frames, RAFT at 64x96 with 2 iterations, the packing; the pairs load
    through ``--dataset shutterstock`` with an integer ``--track_id``."""
    from dynamic_video_depth_tpu_torch.data import get_dataset

    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    write_h5_track(join(raw, "0007"), n=4, h=64, w=96, seed=1)
    monkeypatch.setattr(flows, "RAFT_RES", (64, 96))
    monkeypatch.setattr(flows, "RAFT_ITERS", 2)
    run_shutterstock.main(["--raw_root", raw, "--track", "0007",
                           "--out_root", out, "--gaps", "1,2",
                           "--raft_ckpt", str(tmp_path / "none"),
                           "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "stage 1 done: 4 frames" in printed and "stage 3 done" in printed
    opt = argparse.Namespace(track_id="0", gaps="1,2", subsample=False,
                             data_root=out)
    ds = get_dataset("shutterstock")(opt, "train")
    assert opt.track_id == "0007" and len(ds) == 2 + 1
    for i in range(len(ds)):
        b = ds[i]
        assert b["img_1"].shape == (1, 64, 96, 3)
        assert np.isfinite(b["flow_1_2"]).all()
    vali = get_dataset("shutterstock")(opt, "vali")
    frame = vali[0]
    assert frame["img"].shape == (1, 64, 96, 3)
    assert np.isfinite(frame["depth_mvs"]).all()
