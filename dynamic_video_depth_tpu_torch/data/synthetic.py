"""Synthetic video fixture generator (counterpart of
``dynamic_video_depth_tpu/data/synthetic.py``; numpy + torch only, the same
generator, so both packages write identical files from one seed).

Writes a miniature dataset in the reference datafile layout
(frames_midas/<track>/frame_XXXXX.npz + sequences_select_pairs_midas/<track>/
001/shuffle_False_gap_GG_sequence_CCCCC.pt) so the loader and trainer run
without the DAVIS artifacts. The scene is a textured plane (+ an optional
moving square) seen by a slowly translating camera; flows are the exact
depth-induced flows, so the optimization has a consistent solution.
``synthetic_batch`` makes a batch of random pairs in memory, the
benchmark's input.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np


def _sample_mask(mask: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Nearest-neighbor boolean mask lookup with border clamp."""
    h, w = mask.shape
    iy = np.clip(np.round(ys).astype(int), 0, h - 1)
    ix = np.clip(np.round(xs).astype(int), 0, w - 1)
    return mask[iy, ix]


def _smooth_noise(rng, h, w, scale=4):
    small = rng.rand(h // scale + 2, w // scale + 2)
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
    a = small[yi][:, xi]
    b = small[yi][:, xi + 1]
    c = small[yi + 1][:, xi]
    d = small[yi + 1][:, xi + 1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def make_track(
    root: str,
    track: str = "dog",
    n_frames: int = 12,
    h: int = 64,
    w: int = 96,
    gaps=(1, 2),
    seed: int = 0,
    moving_object: bool = False,
    object_velocity=(0.08, 0.0, 0.0),
):
    """Generate a synthetic track under ``root`` in reference layout.

    With ``moving_object`` a foreground square at a nearer depth translates
    with constant world velocity; depths, flows, occlusion and motion
    segmentation are all EXACT two-layer geometry, so the scene-flow field
    has a known ground-truth solution (``object_velocity`` per frame).
    """
    import torch

    rng = np.random.RandomState(seed)
    frame_dir = join(root, "frames_midas", track)
    seq_dir = join(root, "sequences_select_pairs_midas", track, "001")
    os.makedirs(frame_dir, exist_ok=True)
    os.makedirs(seq_dir, exist_ok=True)

    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)

    texture = _smooth_noise(rng, h, w, 8)
    base_depth = 2.0 + 2.0 * _smooth_noise(rng, h, w, 16)

    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix_h = np.stack([xx, yy, np.ones_like(xx)], -1)  # [H, W, 3]

    vel = np.asarray(object_velocity, np.float32)
    fg_depth = 1.2  # in front of the 2..4 background
    # foreground world square at frame 0, centered mid-image
    cx0, cy0 = w * 0.35, h * 0.4
    half = min(h, w) * 0.15

    def fg_region(i):
        """Pixel mask of the moving square in frame i (exact projection)."""
        if not moving_object:
            return np.zeros((h, w), bool)
        pose = frame_pose(i)
        # square corners in world space at time i
        c0 = np.array([(cx0 - w / 2) / f * fg_depth,
                       (cy0 - h / 2) / f * fg_depth, fg_depth])
        c0 = c0 + vel * i
        # project center + extent into frame i
        rel = c0 - pose[:3, 3]
        cam = pose[:3, :3].T @ rel
        pix = (K @ cam)[:2] / cam[2]
        half_px = half * fg_depth / cam[2]
        return ((np.abs(xx - pix[0]) < half_px)
                & (np.abs(yy - pix[1]) < half_px))

    def frame_pose(i):
        t = np.array([0.02 * i, 0.005 * i, -0.01 * i], np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = t
        return pose

    frames = []
    for i in range(n_frames):
        pose = frame_pose(i)
        img = np.stack(
            [texture, np.roll(texture, i, axis=1), 1 - texture], axis=-1
        ).astype(np.float32)
        depth = base_depth.astype(np.float32).copy()
        region = fg_region(i)
        if moving_object:
            # camera-frame depth of the fg plane (z = fg_depth in world,
            # camera z offset by pose z)
            depth[region] = fg_depth - pose[2, 3]
            img[region] = np.array([1.0, 0.2, 0.1], np.float32)

        np.savez(
            join(frame_dir, "frame_%05d.npz" % i),
            img=img,
            pose_c2w=pose,
            intrinsics=K,
            depth_pred=depth,
            depth_mvs=depth,
            img_orig=img,
            motion_seg=region.astype(np.float32) if moving_object
            else np.ones((h, w), np.float32),
        )
        frames.append(dict(img=img, pose=pose, depth=depth, region=region))

    # exact depth-induced flow between frames: static background + the
    # foreground layer advected by the object velocity
    def flow_1_2(i, j):
        d = frames[i]["depth"]
        cam = d[..., None] * (pix_h @ K_inv.T)
        world = cam @ frames[i]["pose"][:3, :3].T + frames[i]["pose"][:3, 3]
        if moving_object:
            world = world + frames[i]["region"][..., None] * vel * (j - i)
        rel = world - frames[j]["pose"][:3, 3]
        cam2 = rel @ frames[j]["pose"][:3, :3]  # R^T rows
        img2 = cam2 @ K.T
        pix2 = img2[..., :2] / img2[..., 2:3]
        return (pix2 - pix_h[..., :2]).astype(np.float32)

    def occlusion(i, j):
        """1 where a frame-i pixel is covered/invalid in frame j: background
        pixels whose target lands inside frame j's foreground square."""
        if not moving_object:
            return np.zeros((h, w), np.float32)
        fl = flow_1_2(i, j)
        tx = xx + fl[..., 0]
        ty = yy + fl[..., 1]
        target_in_fg = _sample_mask(frames[j]["region"], ty, tx)
        bg = ~frames[i]["region"]
        return (bg & target_in_fg).astype(np.float32)

    for g in gaps:
        cnt = 0
        for i in range(n_frames - 1 - g):
            j = i + g
            f12 = flow_1_2(i, j)
            f21 = flow_1_2(j, i)
            # reference stage-2 convention (generate_flows.py:139-148):
            # mask_2 lives on the FRAME-1 pixel grid (validity toward frame
            # 2, used by the losses); mask_1 on the frame-2 grid.
            mask_2 = torch.from_numpy(
                1.0 - occlusion(i, j)
            ).reshape(1, h, w, 1, 1).float()
            mask_1 = torch.from_numpy(
                1.0 - occlusion(j, i)
            ).reshape(1, h, w, 1, 1).float()
            mseg = torch.from_numpy(
                frames[i]["region"].astype(np.float32)
            ).reshape(1, h, w, 1, 1) if moving_object else torch.ones(1, h, w, 1, 1)
            sample = {
                "R_1": torch.from_numpy(frames[i]["pose"][:3, :3].T.copy()).reshape(1, 1, 1, 3, 3),
                "R_2": torch.from_numpy(frames[j]["pose"][:3, :3].T.copy()).reshape(1, 1, 1, 3, 3),
                "R_1_T": torch.from_numpy(frames[i]["pose"][:3, :3].copy()).reshape(1, 1, 1, 3, 3),
                "R_2_T": torch.from_numpy(frames[j]["pose"][:3, :3].copy()).reshape(1, 1, 1, 3, 3),
                "t_1": torch.from_numpy(frames[i]["pose"][:3, 3].copy()).reshape(1, 1, 1, 1, 3),
                "t_2": torch.from_numpy(frames[j]["pose"][:3, 3].copy()).reshape(1, 1, 1, 1, 3),
                "K": torch.from_numpy(K.T.copy()).reshape(1, 1, 1, 3, 3),
                "K_inv": torch.from_numpy(K_inv.T.copy()).reshape(1, 1, 1, 3, 3),
                "img_1": torch.from_numpy(frames[i]["img"])[None],
                "img_2": torch.from_numpy(frames[j]["img"])[None],
                "depth_1": torch.from_numpy(frames[i]["depth"])[None, None],
                "depth_pred_1": torch.from_numpy(frames[i]["depth"])[None, None],
                "flow_1_2": torch.from_numpy(f12)[None],
                "flow_2_1": torch.from_numpy(f21)[None],
                "mask_1": mask_1,
                "mask_2": mask_2,
                "motion_seg_1": mseg,
                "fid_1": torch.FloatTensor([i]),
                "fid_2": torch.FloatTensor([j]),
            }
            torch.save(
                sample,
                join(seq_dir, f"shuffle_False_gap_{g:02d}_sequence_{cnt:05d}.pt"),
            )
            cnt += 1
    return frame_dir, seq_dir


def make_raw_davis(n_frames: int = 8, h: int = 448, w: int = 768,
                   seed: int = 0, n_points: int = 4000):
    """A raw DAVIS track in memory, as ``preprocess/run_davis.py::
    load_davis_track`` returns it: ``(imgs, matrices, K, points_3d,
    masks)``. Frames ``[h, w, 3]`` in [0, 1] of a texture that drifts to the
    right; camera matrices (cam-to-world, graphics axes: the camera looks
    down -z) of a camera moving slowly forward; triangulated points 3-8 m in
    front of the first camera, inside its view; a moving-object disc mask
    per frame."""
    rng = np.random.RandomState(seed)
    texture = _smooth_noise(rng, h, w, 16)
    shade = _smooth_noise(rng, h, w, 32)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    imgs, matrices, masks = [], [], []
    for i in range(n_frames):
        tex = np.roll(texture, 2 * i, axis=1)
        imgs.append(np.stack([tex, 0.5 * (tex + shade), 1.0 - tex],
                             -1).astype(np.float32))
        m = np.eye(4)
        m[:3, 3] = [0.01 * i, 0.002 * i, -0.02 * i]
        matrices.append(m)
        cx, cy, r = w * (0.3 + 0.02 * i), h * 0.5, 0.12 * min(h, w)
        masks.append(((xx - cx) ** 2 + (yy - cy) ** 2 < r * r)
                     .astype(np.float32))
    d = 3.0 + 5.0 * rng.rand(n_points)
    u, v = rng.rand(n_points) * w, rng.rand(n_points) * h
    points = np.stack([(u - w / 2) / f * d, -(v - h / 2) / f * d, -d], -1)
    return imgs, np.stack(matrices), K, points, masks


def write_raw_davis(root: str, track: str, n_frames: int = 4, h: int = 64,
                    w: int = 96, seed: int = 1) -> None:
    """``make_raw_davis`` written in the raw layout that ``preprocess/
    run_davis.py::load_davis_track`` reads: JPEG frames, PNG masks and the
    triangulation text files under ``root``."""
    from PIL import Image

    imgs, matrices, K, points, masks = make_raw_davis(n_frames, h, w,
                                                      seed=seed)
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
    idx = np.arange(n_frames)[:, None]
    np.savetxt(join(tri, f"{track}.intrinsics.txt"), np.hstack(
        [idx, np.tile([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], (n_frames, 1))]))
    np.savetxt(join(tri, f"{track}.matrices.txt"),
               np.hstack([idx, matrices.reshape(n_frames, 16)]))
    with open(join(tri, f"{track}.obj"), "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in points)


def synthetic_batch(b: int, h: int, w: int, rng: np.random.RandomState,
                    device):
    """``b`` random pairs at ``h x w`` in the train step's batch layout, as
    float32 tensors on ``device`` (counterpart of ``__graft_entry__.py::
    _synthetic_batch``, the benchmark's input): random images and flows,
    full masks, identity rotations, a 1 cm translation, intrinsics with a
    focal length of 0.8 w. The arrays come from the same draws of ``rng``
    in the same order, so both packages make the same batch from one
    seed."""
    import torch

    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    batch = {
        "img_1": rng.rand(b, h, w, 3).astype(np.float32),
        "img_2": rng.rand(b, h, w, 3).astype(np.float32),
        "flow_1_2": rng.randn(b, h, w, 2).astype(np.float32),
        "flow_2_1": rng.randn(b, h, w, 2).astype(np.float32),
        "mask_1": np.ones((b, h, w), np.float32),
        "mask_2": np.ones((b, h, w), np.float32),
        "motion_seg_1": np.ones((b, h, w, 1), np.float32),
        "R_1": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        "R_2": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        "K": np.tile(K, (b, 1, 1)),
        "K_inv": np.tile(np.linalg.inv(K).astype(np.float32), (b, 1, 1)),
        "t_1": np.zeros((b, 3), np.float32),
        "t_2": np.full((b, 3), 0.01, np.float32),
        "time_stamp_1": np.zeros((b, h, w, 1), np.float32),
        "time_stamp_2": np.full((b, h, w, 1), 0.1, np.float32),
        "time_step": np.float32(0.1),
        "frame_id_1": np.zeros((b,), np.float32),
        "frame_id_2": np.ones((b,), np.float32),
    }
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}
