"""A synthetic DAVIS-layout track made from a seed (a copy of the port's
``data/synthetic.py::make_track``, kept with the benchmark so that the
program cannot change its own input).

Writes ``frames_midas/<track>/frame_XXXXX.npz`` and
``sequences_select_pairs_midas/<track>/001/shuffle_False_gap_GG_sequence_
CCCCC.pt`` under ``root``: a textured plane seen by a slowly translating
camera, with a moving square in front of it; flows, occlusion masks and the
motion segmentation are the exact two-layer geometry. Unlike the original,
every gap gets the same number of pairs, ``pairs_per_gap``, the pairs
``(i, i + g)`` for ``i < pairs_per_gap``: a round of the trainer's epoch
order then holds every gap equally often. Pair ``(i, i + g)`` is file
``sequence_{i:05d}`` of its gap, which is how the reference finds a pair
from its frame ids.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Sequence

import numpy as np
import torch

FRAME_DIR = "frames_midas"
SEQ_DIR = "sequences_select_pairs_midas"


def pair_path(root: str, track: str, gap: int, first: int) -> str:
    """The packed file of pair ``(first, first + gap)``."""
    return join(root, SEQ_DIR, track, "001",
                f"shuffle_False_gap_{gap:02d}_sequence_{first:05d}.pt")


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
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx)
            + d * fy * fx)


def make_track(root: str, track: str, h: int, w: int, gaps: Sequence[int],
               pairs_per_gap: int, seed: int) -> int:
    """Write the track; returns its number of frames
    (``pairs_per_gap + max(gaps)``)."""
    rng = np.random.RandomState(seed % 2 ** 32)
    n_frames = pairs_per_gap + max(gaps)
    frame_dir = join(root, FRAME_DIR, track)
    os.makedirs(frame_dir, exist_ok=True)
    os.makedirs(os.path.dirname(pair_path(root, track, 1, 0)), exist_ok=True)

    f = 0.8 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    texture = _smooth_noise(rng, h, w, 8)
    base_depth = 2.0 + 2.0 * _smooth_noise(rng, h, w, 16)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix_h = np.stack([xx, yy, np.ones_like(xx)], -1)
    vel = np.asarray((0.08, 0.0, 0.0), np.float32)
    fg_depth = 1.2
    cx0, cy0 = w * 0.35, h * 0.4
    half = min(h, w) * 0.15

    def frame_pose(i):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (0.02 * i, 0.005 * i, -0.01 * i)
        return pose

    def fg_region(i):
        pose = frame_pose(i)
        c0 = np.array([(cx0 - w / 2) / f * fg_depth,
                       (cy0 - h / 2) / f * fg_depth, fg_depth]) + vel * i
        cam = pose[:3, :3].T @ (c0 - pose[:3, 3])
        pix = (K @ cam)[:2] / cam[2]
        half_px = half * fg_depth / cam[2]
        return (np.abs(xx - pix[0]) < half_px) & (np.abs(yy - pix[1])
                                                   < half_px)

    frames = []
    for i in range(n_frames):
        pose = frame_pose(i)
        img = np.stack([texture, np.roll(texture, i, axis=1), 1 - texture],
                       axis=-1).astype(np.float32)
        depth = base_depth.astype(np.float32).copy()
        region = fg_region(i)
        depth[region] = fg_depth - pose[2, 3]
        img[region] = np.array([1.0, 0.2, 0.1], np.float32)
        np.savez(join(frame_dir, "frame_%05d.npz" % i), img=img,
                 pose_c2w=pose, intrinsics=K, depth_pred=depth,
                 depth_mvs=depth, img_orig=img,
                 motion_seg=region.astype(np.float32))
        frames.append(dict(img=img, pose=pose, depth=depth, region=region))

    def flow_1_2(i, j):
        cam = frames[i]["depth"][..., None] * (pix_h @ K_inv.T)
        world = cam @ frames[i]["pose"][:3, :3].T + frames[i]["pose"][:3, 3]
        world = world + frames[i]["region"][..., None] * vel * (j - i)
        cam2 = (world - frames[j]["pose"][:3, 3]) @ frames[j]["pose"][:3, :3]
        img2 = cam2 @ K.T
        return (img2[..., :2] / img2[..., 2:3] - pix_h[..., :2]).astype(
            np.float32)

    def occlusion(i, j, fl):
        iy = np.clip(np.round(yy + fl[..., 1]).astype(int), 0, h - 1)
        ix = np.clip(np.round(xx + fl[..., 0]).astype(int), 0, w - 1)
        target_in_fg = frames[j]["region"][iy, ix]
        return (~frames[i]["region"] & target_in_fg).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    for g in gaps:
        for i in range(pairs_per_gap):
            j = i + g
            f12, f21 = flow_1_2(i, j), flow_1_2(j, i)
            pi, pj = frames[i]["pose"], frames[j]["pose"]
            sample = {
                "R_1": t(pi[:3, :3].T).reshape(1, 1, 1, 3, 3),
                "R_2": t(pj[:3, :3].T).reshape(1, 1, 1, 3, 3),
                "R_1_T": t(pi[:3, :3]).reshape(1, 1, 1, 3, 3),
                "R_2_T": t(pj[:3, :3]).reshape(1, 1, 1, 3, 3),
                "t_1": t(pi[:3, 3]).reshape(1, 1, 1, 1, 3),
                "t_2": t(pj[:3, 3]).reshape(1, 1, 1, 1, 3),
                "K": t(K.T).reshape(1, 1, 1, 3, 3),
                "K_inv": t(K_inv.T).reshape(1, 1, 1, 3, 3),
                "img_1": t(frames[i]["img"])[None],
                "img_2": t(frames[j]["img"])[None],
                "depth_1": t(frames[i]["depth"])[None, None],
                "depth_pred_1": t(frames[i]["depth"])[None, None],
                "flow_1_2": t(f12)[None],
                "flow_2_1": t(f21)[None],
                "mask_1": t(1.0 - occlusion(j, i, f21)).reshape(1, h, w, 1, 1),
                "mask_2": t(1.0 - occlusion(i, j, f12)).reshape(1, h, w, 1, 1),
                "motion_seg_1": t(frames[i]["region"].astype(
                    np.float32)).reshape(1, h, w, 1, 1),
                "fid_1": torch.tensor([float(i)]),
                "fid_2": torch.tensor([float(j)]),
            }
            torch.save(sample, pair_path(root, track, g, i))
    return n_frames
