"""The port's preprocessing against the JAX package's: the two resize
configurations preprocessing adds, stage 1 (``process_track`` and
``process_davis_track`` with a stand-in depth function), the stage-2 flow
utilities and ``process_track`` with RAFT from one shared checkpoint, stage 3
``.pt`` files byte for byte, the whole pipeline into a port train step, and
the entry on a tiny raw track. Inputs come from numpy with a seed."""

import argparse
import os
from os.path import join

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynamic_video_depth_tpu.ops import resize as jax_resize
from dynamic_video_depth_tpu.preprocess import flows as jax_flows
from dynamic_video_depth_tpu.preprocess import frames as jax_frames
from dynamic_video_depth_tpu.preprocess import pairs as jax_pairs
from dynamic_video_depth_tpu_torch.data.synthetic import (make_raw_davis,
                                                          make_track)
from dynamic_video_depth_tpu_torch.ops import resize
from dynamic_video_depth_tpu_torch.preprocess import flows, frames, pairs

FRAME_KEYS = ("img", "pose_c2w", "intrinsics", "depth_pred", "depth_mvs",
              "img_orig", "motion_seg")
FLOW_KEYS = ("flow_1_2", "flow_2_1", "mask_1", "mask_2")


def small_raft(mp):
    """RAFT at 64x96 with 2 iterations, in the port and the JAX package
    (both read the two module constants at each call)."""
    for mod in (flows, jax_flows):
        mp.setattr(mod, "RAFT_RES", (64, 96))
        mp.setattr(mod, "RAFT_ITERS", 2)


def stand_in_depth(imgs):
    """A smooth positive depth of the image, in place of MiDaS."""
    return 2.0 + np.asarray(imgs).mean(-1)


def _npz(path):
    with np.load(path) as f:
        return dict(f)


def _assert_npz_dirs_match(ours, ref, keys, **tol):
    names = sorted(os.listdir(ref))
    assert names and sorted(os.listdir(ours)) == names
    for name in names:
        a, b = _npz(join(ours, name)), _npz(join(ref, name))
        assert sorted(a) == sorted(b) == sorted(keys), name
        for k in keys:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], **tol,
                                       err_msg=f"{name}:{k}")


@pytest.mark.parametrize("mode,in_hw,out_hw", [
    ("bicubic", (288, 512), (224, 384)),   # stage 2's flows, DAVIS 1080p
    ("bicubic", (288, 512), (256, 384)),   # the smoke's 448x768 raw track
    ("bilinear", (1080, 1920), (224, 384)),  # raw DAVIS to working res
    ("bilinear", (1080, 1920), (288, 512)),  # raw DAVIS to RAFT res
    ("bilinear", (448, 768), (256, 384)),
])
def test_preprocessing_resizes_match_jax(rng, mode, in_hw, out_hw):
    """The downscales preprocessing adds: bicubic align_corners=False
    (``_cubic_matrix``, the source index not clamped) and bilinear
    align_corners=False without antialias (``_linear_matrix``), applied in
    float64. In float64 the port agrees to the matrices' float32 weights
    (1e-7); in float32 torch computes the source positions in float32, off
    by up to ~1e-4 px at 1080 -> 224, so on data in [0, 1) it agrees to
    2e-4."""
    x = rng.rand(1, *in_hw, 2)
    matrix = getattr(jax_resize, "_cubic_matrix" if mode == "bicubic"
                     else "_linear_matrix")
    mh = matrix(in_hw[0], out_hw[0], False).astype(np.float64)
    mw = matrix(in_hw[1], out_hw[1], False).astype(np.float64)
    ref = np.einsum("ow,bhwc->bhoc", mw, np.einsum("oh,bhwc->bowc", mh, x))
    fn = getattr(resize, f"resize_{mode}")
    out = fn(torch.from_numpy(x), out_hw, False).numpy()
    assert out.shape == (1, *out_hw, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)
    out32 = fn(torch.from_numpy(x.astype(np.float32)), out_hw, False)
    np.testing.assert_allclose(out32.numpy(), ref, rtol=0, atol=2e-4)


def _raw_frames(rng, n=5, h=40, w=60):
    """Raw frames of ``frames.process_track``: graphics w2c poses and dense
    metric depth."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    out = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.01 * i, 0.0, -0.005 * i]
        f = 0.8 * w
        out.append({
            "img": rng.rand(h, w, 3).astype(np.float32),
            "pose_w2c": (flip @ np.linalg.inv(c2w)).astype(np.float32),
            "intrinsics": np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                                   np.float32),
            "depth_mvs": (2.0 + rng.rand(h, w)).astype(np.float32),
            "motion_seg": (rng.rand(h, w) > 0.7).astype(np.float32),
        })
    return out


def test_stage1_process_track_matches_jax(tmp_path, rng):
    raw = _raw_frames(rng)
    kw = dict(max_width=48, multiple_of=16)
    s = frames.process_track(raw, str(tmp_path / "ours"), stand_in_depth,
                             **kw)
    s_ref = jax_frames.process_track(raw, str(tmp_path / "ref"),
                                     stand_in_depth, **kw)
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    _assert_npz_dirs_match(str(tmp_path / "ours"), str(tmp_path / "ref"),
                           FRAME_KEYS, rtol=1e-5, atol=1e-6)


def test_stage1_process_davis_track_matches_jax(tmp_path):
    imgs, matrices, K, points, masks = make_raw_davis(5, 64, 96, seed=3)
    kw = dict(max_width=48, multiple_of=16, depth_batch=2)
    args = (imgs, matrices, K, points, masks)
    s = frames.process_davis_track(*args, str(tmp_path / "ours"),
                                   stand_in_depth, **kw)
    s_ref = jax_frames.process_davis_track(*args, str(tmp_path / "ref"),
                                           stand_in_depth, **kw)
    assert s > 0
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    _assert_npz_dirs_match(str(tmp_path / "ours"), str(tmp_path / "ref"),
                           FRAME_KEYS, rtol=1e-5, atol=1e-6)
    seg = _npz(join(str(tmp_path / "ours"), "frame_00000.npz"))["motion_seg"]
    assert seg.shape == (32, 48) and set(np.unique(seg)) <= {0.0, 1.0}


def test_flow_utilities_match_jax(rng, monkeypatch):
    f12 = (rng.randn(36, 64, 2) * 3.0).astype(np.float32)
    f21 = (-f12 + 0.8 * rng.randn(36, 64, 2)).astype(np.float32)
    t = torch.from_numpy
    for flow in (f12, f21):
        np.testing.assert_allclose(flows.resize_flow(t(flow), (24, 40)),
                                   jax_flows.resize_flow(flow, (24, 40)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(flows.oob_mask(t(flow)),
                                      jax_flows.oob_mask(flow))
    ours = flows.occlusion_masks(t(f12), t(f21))
    ref = jax_flows.occlusion_masks(f12, f21)
    for a, b in zip(ours, ref):
        a = a.numpy()
        assert a.dtype == b.dtype == np.uint8
        assert 0 < a.sum() < a.size  # both occluded and visible pixels
        np.testing.assert_array_equal(a, b)
    # values in [0, 255]: 2e-4 of the range, the float32 resize bound of
    # test_preprocessing_resizes_match_jax
    small_raft(monkeypatch)
    frame = {"img_orig": rng.rand(90, 140, 3).astype(np.float32)}
    ours = flows._prep_raft_input(frame, "cpu")
    assert ours.shape == (64, 96, 3)
    np.testing.assert_allclose(ours, jax_flows._prep_raft_input(frame),
                               rtol=0, atol=255 * 2e-4)


def shifted_flows(h, w, shift=4.6, block=3.0):
    """A pair of RAFT-resolution flows moving ``shift`` px right and back,
    but inconsistent in one block (the backward flow there moves ``block``
    px right): both masks hold occluded pixels (the block, and the columns
    whose target leaves the frame) and visible ones."""
    f12 = np.zeros((h, w, 2), np.float32)
    f12[..., 0] = shift
    f21 = -f12
    f21[h // 4:h // 2, w // 3:w // 2, 0] = block
    return f12, f21


def test_postprocess_pair_of_known_shift_matches_jax():
    """``postprocess_pair`` on flows of a known shift (the resize to the
    working resolution, the fwd/bwd check and the out-of-bounds test) gives
    the JAX package's flows and masks, and masks that are neither all 0 nor
    all 1."""
    f12, f21 = shifted_flows(72, 128)
    ours = flows.postprocess_pair(torch.from_numpy(f12),
                                  torch.from_numpy(f21), (32, 48))
    ref = jax_flows.postprocess_pair(f12, f21, (32, 48))
    assert sorted(ours) == sorted(ref) == sorted(FLOW_KEYS)
    for k in ("flow_1_2", "flow_2_1"):
        assert ours[k].dtype == np.float32 and ours[k].shape == (32, 48, 2)
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-5)
    for k in ("mask_1", "mask_2"):
        assert ours[k].dtype == np.uint8
        assert 0 < ours[k].mean() < 1
        np.testing.assert_array_equal(ours[k], ref[k])


def _official_checkpoint(path):
    """A random RAFT saved in the official ``nn.DataParallel`` layout."""
    from dynamic_video_depth_tpu_torch.models.raft import RAFT

    net = RAFT(generator=torch.Generator().manual_seed(5))
    torch.save({"module." + k: v for k, v in net.state_dict().items()}, path)
    return path


@pytest.fixture(scope="module")
def stage12(tmp_path_factory):
    """Stage 1 (synthetic frames) and stage 2 of the port and of the JAX
    package from one shared RAFT checkpoint, at 64x96 with 2 iterations."""
    root = str(tmp_path_factory.mktemp("stage12"))
    frame_dir, _ = make_track(root, track="dog", n_frames=4, h=32, w=48,
                              gaps=(1,))
    ckpt = _official_checkpoint(join(root, "raft-sintel.pth"))
    with pytest.MonkeyPatch.context() as mp:
        small_raft(mp)
        flows.process_track(frame_dir, join(root, "ours"), gaps=(1, 2),
                            ckpt_path=ckpt, device="cpu")
        jax_flows.process_track(frame_dir, join(root, "ref"), gaps=(1, 2),
                                ckpt_path=ckpt)
    return root, frame_dir


def test_stage2_process_track_matches_jax(stage12):
    root, _ = stage12
    ours, ref = join(root, "ours"), join(root, "ref")
    names = sorted(os.listdir(ref))
    assert len(names) == 3 + 2 and sorted(os.listdir(ours)) == names
    for name in names:
        a, b = _npz(join(ours, name)), _npz(join(ref, name))
        assert sorted(a) == sorted(b)
        for k in ("flow_1_2", "flow_2_1"):
            assert a[k].shape == (32, 48, 2) and np.isfinite(a[k]).all()
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{name}:{k}")
        for k in ("mask_1", "mask_2"):
            assert a[k].dtype == np.uint8 and set(np.unique(a[k])) <= {0, 1}
            # thresholded: pixels within float noise of 1 px may flip
            assert np.abs(a[k].astype(int) - b[k].astype(int)).mean() < 0.01
        for k in ("frame_id_1", "frame_id_2"):
            assert int(a[k]) == int(b[k])


def test_flow_fn_and_generate_pair_match_jax(stage12, monkeypatch):
    """The one-pair flow function from the official checkpoint, through
    ``generate_pair`` (input resize, RAFT, flow resize, masks)."""
    root, frame_dir = stage12
    ckpt = join(root, "raft-sintel.pth")
    im1, im2 = (_npz(join(frame_dir, f"frame_{i:05d}.npz")) for i in (0, 1))
    small_raft(monkeypatch)
    ours = flows.generate_pair(flows.make_raft_flow_fn(ckpt, "cpu"), im1, im2,
                               "cpu")
    ref = jax_flows.generate_pair(jax_flows.make_raft_flow_fn(ckpt), im1, im2)
    for k in ("flow_1_2", "flow_2_1"):
        assert ours[k].shape == (32, 48, 2)
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, atol=1e-4)
    for k in ("mask_1", "mask_2"):
        assert np.abs(ours[k].astype(int) - ref[k].astype(int)).mean() < 0.01


def test_stage3_pt_files_equal_jax(stage12, tmp_path):
    """Packed from the same stage-1 and stage-2 files, every ``.pt`` is
    byte for byte the JAX package's."""
    root, frame_dir = stage12
    flow_dir = join(root, "ref")
    pairs.pack_track(frame_dir, flow_dir, str(tmp_path / "ours"), gaps=(1, 2))
    jax_pairs.pack_track(frame_dir, flow_dir, str(tmp_path / "ref"),
                         gaps=(1, 2))
    names = sorted(os.listdir(tmp_path / "ref"))
    # n - 1 - gap pairs per gap (generate_sequence_midas.py:186)
    assert len(names) == 2 + 1
    assert sorted(os.listdir(tmp_path / "ours")) == names
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_full_pipeline_to_train_step(tmp_path, rng, monkeypatch):
    """Raw frames -> stage 1 (stand-in depth) -> stage 2 (the port's RAFT at
    64x96) -> stage 3 -> the port's loader -> one train step and one vali
    step with finite losses."""
    from dynamic_video_depth_tpu_torch.data.batches import to_device
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.train import (
        LossConfig, SceneFlowMotionFieldStep, TrainStepConfig)

    root = str(tmp_path)
    frame_dir = join(root, "frames_midas", "dog")
    flow_dir = join(root, "flow_pairs", "dog")
    seq_dir = join(root, "sequences_select_pairs_midas", "dog", "001")
    frames.process_track(_raw_frames(rng, n=6, h=32, w=48), frame_dir,
                         stand_in_depth, max_width=48, multiple_of=16)
    small_raft(monkeypatch)
    flows.process_track(frame_dir, flow_dir, gaps=(1, 2), device="cpu")
    pairs.pack_track(frame_dir, flow_dir, seq_dir, gaps=(1, 2))

    opt = argparse.Namespace(track_id="dog", gaps="1,2", subsample=False,
                             data_root=root)
    ds = Dataset(opt, mode="train")
    assert len(ds) == 4 + 3
    step = SceneFlowMotionFieldStep(TrainStepConfig(
        lr=1e-4, scene_lr_mul=10.0, depth_net="tiny", net_width=16,
        n_layers=1, n_freq_xyz=2, n_freq_t=1,
        loss=LossConfig(flow_mul=1.0, disp_mul=1.0, acc_mul=1.0,
                        use_disp=True)), device="cpu")
    sample = ds[0]
    logs = step.train_step(to_device(sample, "cpu"), sample["steps"], False)
    assert np.isfinite(float(logs["loss"]))
    _, vlogs = step.vali_step(to_device(Dataset(opt, mode="vali")[0], "cpu"))
    assert np.isfinite(float(vlogs["loss"]))


def _write_raw_davis(root, track, n=4, h=64, w=96):
    """The raw layout ``run_davis.load_davis_track`` reads: JPEG frames, PNG
    masks and the triangulation text files."""
    from PIL import Image

    imgs, matrices, K, points, masks = make_raw_davis(n, h, w, seed=1)
    fdir = join(root, "JPEGImages", "1080p", track)
    mdir = join(root, "Annotations", "1080p", track)
    tri = join(root, "triangulation")
    for d in (fdir, mdir, tri):
        os.makedirs(d, exist_ok=True)
    for i, (img, m) in enumerate(zip(imgs, masks)):
        Image.fromarray((img * 255).astype(np.uint8)).save(
            join(fdir, f"{i:05d}.jpg"))
        Image.fromarray((m * 255).astype(np.uint8)).save(
            join(mdir, f"{i:05d}.png"))
    idx = np.arange(n)[:, None]
    np.savetxt(join(tri, f"{track}.intrinsics.txt"), np.hstack(
        [idx, np.tile([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], (n, 1))]))
    np.savetxt(join(tri, f"{track}.matrices.txt"),
               np.hstack([idx, matrices.reshape(n, 16)]))
    with open(join(tri, f"{track}.obj"), "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in points)


def test_entry_runs_on_a_tiny_raw_track(tmp_path, monkeypatch, capsys):
    """``python -m dynamic_video_depth_tpu_torch.preprocess`` on the CPU:
    MiDaS and RAFT with random weights (RAFT at 64x96, 2 iterations), all
    three stages, and every packed pair loads."""
    from dynamic_video_depth_tpu_torch.data.davis_sequence import Dataset
    from dynamic_video_depth_tpu_torch.preprocess import run_davis

    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    _write_raw_davis(raw, "dog")
    small_raft(monkeypatch)
    run_davis.main(["--raw_root", raw, "--track", "dog", "--out_root", out,
                    "--gaps", "1,2", "--raft_ckpt", str(tmp_path / "none"),
                    "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "stage 1 done: 4 frames" in printed and "stage 3 done" in printed
    frame = _npz(join(out, "frames_midas", "dog", "frame_00000.npz"))
    assert frame["img"].shape == (64, 96, 3)
    assert np.isfinite(frame["depth_pred"]).all()
    assert len(os.listdir(join(out, "flow_pairs", "dog"))) == 3 + 2
    opt = argparse.Namespace(track_id="dog", gaps="1,2", subsample=False,
                             data_root=out)
    ds = Dataset(opt, mode="train")
    assert len(ds) == 2 + 1
    for i in range(len(ds)):
        assert ds[i]["flow_1_2"].shape == (1, 64, 96, 2)


def test_load_midas_checkpoint_by_port_keys(tmp_path):
    """The MiDaS loader takes the ``{"model", "optimizer"}`` wrapper, ignores
    keys the net lacks (as ``port_torch_variables`` does) and raises on a
    key the file lacks (shown on a small net: the rule is the net's keys)."""
    from dynamic_video_depth_tpu_torch.models import TinyDepthNet
    from dynamic_video_depth_tpu_torch.runtime import weights

    src = TinyDepthNet(generator=torch.Generator().manual_seed(2))
    sd = dict(src.state_dict(), **{"scratch.unused.weight": torch.zeros(2)})
    path = str(tmp_path / "midas_cpkt.pt")
    torch.save({"model": sd, "optimizer": {}}, path)
    net = weights.load_midas_checkpoint(TinyDepthNet(), path)
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    key = next(iter(src.state_dict()))
    torch.save({k: v for k, v in sd.items() if k != key},
               str(tmp_path / "short.pt"))
    with pytest.raises(KeyError, match="lacks"):
        weights.load_midas_checkpoint(TinyDepthNet(),
                                      str(tmp_path / "short.pt"))
