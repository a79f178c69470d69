"""Preprocessing stage 3: packed per-pair training batches (counterpart of
``dynamic_video_depth_tpu/preprocess/pairs.py``; reference
scripts/preprocess/davis/generate_sequence_midas.py).

Joins the stage-1 frame npzs with the stage-2 flow npzs into the packed
``.pt`` files the training loader reads, byte for byte the layout the JAX
package and the reference write."""

from __future__ import annotations

import os
from glob import glob
from os.path import join
from typing import Sequence

import numpy as np
import torch


def pack_pair(im1: dict, im2: dict, flow: dict, fid_1: int, fid_2: int,
              swapped: bool):
    """One pair batch dict in the reference layout
    (generate_sequence_midas.py:117-178)."""

    def pose_tensors(data, suffix):
        pose = np.asarray(data["pose_c2w"], np.float32)
        R = pose[:3, :3]
        t = pose[:3, 3]
        return {
            f"R_{suffix}": torch.from_numpy(R.T.copy()).reshape(1, 1, 1, 3, 3),
            f"R_{suffix}_T": torch.from_numpy(R.copy()).reshape(1, 1, 1, 3, 3),
            f"t_{suffix}": torch.from_numpy(t.copy()).reshape(1, 1, 1, 1, 3),
        }

    K = np.asarray(im1["intrinsics"], np.float32)
    flow_1_2 = np.asarray(
        flow["flow_2_1"] if swapped else flow["flow_1_2"], np.float32)
    flow_2_1 = np.asarray(
        flow["flow_1_2"] if swapped else flow["flow_2_1"], np.float32)
    mask_1 = np.asarray(flow["mask_1"], np.float32)
    mask_2 = np.asarray(flow["mask_2"], np.float32)
    h, w = mask_1.shape[:2]

    sample = {}
    sample.update(pose_tensors(im1, "1"))
    sample.update(pose_tensors(im2, "2"))
    sample["K"] = torch.from_numpy(K.T.copy()).reshape(1, 1, 1, 3, 3)
    sample["K_inv"] = torch.from_numpy(
        np.linalg.inv(K).T.copy().astype(np.float32)).reshape(1, 1, 1, 3, 3)
    sample["img_1"] = torch.from_numpy(np.asarray(im1["img"], np.float32))[None]
    sample["img_2"] = torch.from_numpy(np.asarray(im2["img"], np.float32))[None]
    sample["depth_1"] = torch.from_numpy(
        np.asarray(im1["depth_mvs"], np.float32))[None, None]
    sample["depth_pred_1"] = torch.from_numpy(
        np.asarray(im1["depth_pred"], np.float32))[None, None]
    sample["flow_1_2"] = torch.from_numpy(flow_1_2)[None]
    sample["flow_2_1"] = torch.from_numpy(flow_2_1)[None]
    # soft validity = 1 - ceil(occlusion) (generate_sequence_midas.py:146-147)
    sample["mask_1"] = 1 - torch.from_numpy(np.ceil(mask_1)).reshape(1, h, w, 1, 1)
    sample["mask_2"] = 1 - torch.from_numpy(np.ceil(mask_2)).reshape(1, h, w, 1, 1)
    if "motion_seg" in im1:
        sample["motion_seg_1"] = torch.from_numpy(
            np.asarray(im1["motion_seg"], np.float32)).reshape(1, h, w, 1, 1)
    else:
        sample["motion_seg_1"] = sample["mask_2"].clone()
    sample["fid_1"] = torch.FloatTensor([fid_1])
    sample["fid_2"] = torch.FloatTensor([fid_2])
    return sample


def pack_track(frame_dir: str, flow_dir: str, out_dir: str,
               gaps: Sequence[int] = (1, 2, 3, 4, 5, 6, 7, 8),
               batch_size: int = 1):
    """Pack every (frame, gap) pair of a track
    (generate_sequence_midas.py:180-193)."""
    os.makedirs(out_dir, exist_ok=True)
    frame_files = sorted(glob(join(frame_dir, "*.npz")))
    n = len(frame_files)

    def load_frame(i):
        return dict(np.load(frame_files[i], allow_pickle=True))

    for gap in gaps:
        cnt = 0
        for f in range(max(n - batch_size - gap, 0)):
            i, j = f, f + gap
            lo, hi = sorted((i, j))
            flow_path = join(flow_dir, f"flowpair_{lo:05d}_{hi:05d}.npz")
            if not os.path.isfile(flow_path):
                continue
            flow = dict(np.load(flow_path, allow_pickle=True))
            sample = pack_pair(load_frame(i), load_frame(j), flow, i, j,
                               swapped=(lo != i))
            torch.save(
                sample,
                join(out_dir,
                     f"shuffle_False_gap_{gap:02d}_sequence_{cnt:05d}.pt"))
            cnt += 1
