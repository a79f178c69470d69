"""Batch schema conversion (counterpart of
``dynamic_video_depth_tpu/data/batches.py``).

Reads the reference's packed per-pair ``.pt`` dicts and per-frame ``.npz``
files into flat channel-last numpy batches:
  img_1/img_2 [B,H,W,3], flow_1_2/flow_2_1 [B,H,W,2], mask_1/mask_2 [B,H,W],
  motion_seg_1 [B,H,W,1], R_1/R_2 [B,3,3] (plain R_c2w), t_1/t_2 [B,3],
  K/K_inv [B,3,3], time_stamp_1/2 [B,H,W,1], time_step [], frame_id_1/2 [B],
  depth_gt_1/depth_pred_1 [B,H,W].
``to_device`` turns such a batch into tensors on the training device
(``host_tensors`` is its host half, pinned for an asynchronous copy).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_packed_pt(path: str) -> Dict[str, np.ndarray]:
    """Load a packed ``.pt`` pair batch into numpy."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in data.items()}


def _unpack_rot(m) -> np.ndarray:
    """[1,1,1,3,3] packed transposed matrix -> [B,3,3] plain matrix."""
    return np.swapaxes(np.asarray(m, np.float32).reshape(-1, 3, 3), -1, -2)


def pair_batch_from_packed(raw: Dict[str, np.ndarray], n_frames: float,
                           unit: float = 1.0) -> Dict[str, np.ndarray]:
    """Packed pair dict -> training batch (reference time stamps:
    datasets/davis_sequence.py:105-115)."""
    img_1 = np.asarray(raw["img_1"], np.float32)
    b, h, w, _ = img_1.shape
    fid_1 = np.asarray(raw["fid_1"], np.float32).reshape(b)
    fid_2 = np.asarray(raw["fid_2"], np.float32).reshape(b)

    def stamp(fid):
        return np.broadcast_to((fid / n_frames)[:, None, None, None],
                               (b, h, w, 1)).astype(np.float32)

    def rep(m):
        return np.broadcast_to(m, (b,) + m.shape[1:]).copy() \
            if m.shape[0] != b else m

    return {
        "img_1": img_1,
        "img_2": np.asarray(raw["img_2"], np.float32),
        "flow_1_2": np.asarray(raw["flow_1_2"], np.float32),
        "flow_2_1": np.asarray(raw["flow_2_1"], np.float32),
        "mask_1": np.asarray(raw["mask_1"], np.float32).reshape(b, h, w),
        "mask_2": np.asarray(raw["mask_2"], np.float32).reshape(b, h, w),
        "motion_seg_1": np.asarray(raw["motion_seg_1"],
                                   np.float32).reshape(b, h, w, 1),
        "R_1": rep(_unpack_rot(raw["R_1"])),
        "R_2": rep(_unpack_rot(raw["R_2"])),
        "K": rep(_unpack_rot(raw["K"])),
        "K_inv": rep(_unpack_rot(raw["K_inv"])),
        "t_1": rep(np.asarray(raw["t_1"], np.float32).reshape(-1, 3)),
        "t_2": rep(np.asarray(raw["t_2"], np.float32).reshape(-1, 3)),
        "time_stamp_1": stamp(fid_1),
        "time_stamp_2": stamp(fid_2),
        "time_step": np.float32(unit / n_frames),
        "frame_id_1": fid_1,
        "frame_id_2": fid_2,
        "depth_gt_1": np.asarray(raw["depth_1"], np.float32).reshape(b, h, w),
        "depth_pred_1": np.asarray(raw["depth_pred_1"],
                                   np.float32).reshape(b, h, w),
    }


def collate_batches(samples) -> Dict[str, np.ndarray]:
    """Concatenate same-gap pair batches along the batch axis; scalars
    (the time step, the gap) are taken from the first sample and strings
    are listed."""
    out = {}
    for key, v0 in samples[0].items():
        if isinstance(v0, str):
            out[key] = [s[key] for s in samples]
        elif np.ndim(v0) == 0:
            out[key] = v0
        else:
            out[key] = np.concatenate([np.asarray(s[key]) for s in samples])
    return out


def frame_batch_from_npz(raw: Dict[str, np.ndarray], idx: int,
                         n_frames: float, unit: float = 1.0
                         ) -> Dict[str, np.ndarray]:
    """Per-frame npz -> validation batch (reference
    datasets/davis_sequence.py:117-152)."""
    img = np.asarray(raw["img"], np.float32)
    h, w, _ = img.shape
    pose = np.asarray(raw["pose_c2w"], np.float32)
    K = np.asarray(raw["intrinsics"], np.float32)
    batch = {
        "img": img[None],
        "time_stamp_1": np.full((1, h, w, 1), idx / n_frames, np.float32),
        "time_step": np.float32(unit / n_frames),
        "frame_id_1": np.asarray([idx], np.float32),
        "depth_pred": np.asarray(raw["depth_pred"], np.float32)[None],
        "depth_mvs": np.asarray(raw["depth_mvs"], np.float32)[None],
        "cam_c2w": pose[None],
        "R_1": pose[None, :3, :3].copy(),
        "t_1": pose[None, :3, 3].copy(),
        "K": K[None],
        "K_inv": np.linalg.inv(K)[None].astype(np.float32),
    }
    if "motion_seg" in raw:
        batch["motion_seg_1"] = np.asarray(
            raw["motion_seg"], np.float32).reshape(1, h, w, 1)
    return batch


def host_tensors(batch: Dict, pin: bool = False) -> Dict:
    """``to_device``'s host half: numpy arrays (and numpy scalars) ->
    float32 CPU tensors, page-locked when ``pin`` (a copy from pageable
    memory is synchronous whatever ``non_blocking`` says); other values
    are kept as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, np.floating)):
            v = torch.as_tensor(np.asarray(v, np.float32))
            if pin:
                v = v.pin_memory()
        out[k] = v
    return out


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Numpy arrays (and numpy scalars) -> float32 tensors on ``device``;
    tensors (``host_tensors``'s) are copied as they are, without waiting
    for the copy when they are pinned; other values (paths, the int gap)
    are dropped."""
    out = {}
    for k, v in host_tensors(batch).items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device, non_blocking=True)
    return out
