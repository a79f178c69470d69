"""Preprocessing stage 1: per-frame depth init and scale calibration
(counterpart of ``dynamic_video_depth_tpu/preprocess/frames.py``; reference
scripts/preprocess/davis/generate_frame_midas.py).

Numpy around two device calls: the depth net (``make_midas_depth_fn``) and
the bilinear resizes (``ops/resize.py``, on the CPU). Per track:
1. run the depth net over every frame,
2. project the triangulated sparse points into each frame and take the
   per-track scale ``s = mean over frames of median(depth_net / depth_mvs)``,
3. flip the world->cam pose convention to cam->world with the y/z sign flip
   and scale the translations by ``s``,
4. resize images and depths to at most ``max_width`` wide with the height a
   multiple of ``multiple_of``,
5. save ``frame_%05d.npz`` with {img, pose_c2w, intrinsics, depth_pred,
   depth_mvs, img_orig, motion_seg}.
"""

from __future__ import annotations

import copy
import os
from os.path import join
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..runtime.device import (cyclic_pad, on_device, resolve_device,
                              slot_devices)


def flip_world_to_cam(pose_w2c: np.ndarray) -> np.ndarray:
    """w2c pose with graphics y/z axes -> c2w pose with vision axes
    (reference: davis generate_frame_midas.py:55 ``pose[1:3] *= -1`` then
    invert)."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float64)
    p = flip @ np.asarray(pose_w2c, np.float64)
    return np.linalg.inv(p).astype(np.float32)


def load_obj_vertices(path: str) -> np.ndarray:
    """Parse the vertex lines of a triangulation ``.obj``."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float64)


def _bilinear_sample(img: np.ndarray, ys: np.ndarray,
                     xs: np.ndarray) -> np.ndarray:
    """``scipy.ndimage.map_coordinates(order=1)`` for a 2D image."""
    h, w = img.shape
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = ys - y0
    fx = xs - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x1] * (1 - fy) * fx
            + img[y1, x0] * fy * (1 - fx) + img[y1, x1] * fy * fx)


def sparse_calibration_scale(points_3d, extrinsics_w2c, K, pred_depths,
                             object_masks=None):
    """Per-track scale from triangulated sparse points (reference: davis
    generate_frame_midas.py:83-112): project the point cloud into each
    frame, keep in-bounds static (object mask < 0.1) points with depth >
    1e-3, and take ``mean over frames of median(pred/mvs)``.

    Args:
      points_3d: ``[P, 3]`` triangulated world points.
      extrinsics_w2c: ``[F, 4, 4]`` flipped world-to-camera matrices.
      K: ``[3, 3]`` intrinsics at the *original* resolution.
      pred_depths: list of ``[H, W]`` depth-net outputs (original res).
      object_masks: optional list of ``[H, W]`` moving-object masks in [0,1].
    """
    h_pt = np.concatenate(
        [points_3d, np.ones((points_3d.shape[0], 1))], axis=1).T
    scales = []
    for x in range(len(pred_depths)):
        cam = extrinsics_w2c[x] @ h_pt
        im_pt = K @ cam[:3]
        depth = im_pt[2].copy()
        im_pt = im_pt / im_pt[2:]
        hh, ww = pred_depths[x].shape
        sel = ((im_pt[0] >= 0) & (im_pt[0] < ww)
               & (im_pt[1] >= 0) & (im_pt[1] < hh))
        pts, d = im_pt[:, sel], depth[sel]
        if object_masks is not None:
            m = _bilinear_sample(object_masks[x], pts[1], pts[0])
            keep = m < 0.1
            pts, d = pts[:, keep], d[keep]
        keep = d > 1e-3
        pts, d = pts[:, keep], d[keep]
        if d.size == 0:
            continue
        pred = _bilinear_sample(pred_depths[x], pts[1], pts[0])
        scales.append(np.median(pred / d))
    return float(np.mean(scales)) if scales else 1.0


def recenter_intrinsics(K: np.ndarray, orig_hw, out_hw) -> np.ndarray:
    """DAVIS stage-1 intrinsics: focal lengths scaled, principal point
    recentred on the image (reference: davis generate_frame_midas.py:
    133-139)."""
    h, w = orig_hw
    th, tw = out_hw
    K2 = np.asarray(K, np.float32).copy()
    K2[0, 0] /= w / tw
    K2[1, 1] /= h / th
    K2[0, 2] = (tw - 1) / 2
    K2[1, 2] = (th - 1) / 2
    return K2


def working_resolution(h: int, w: int, max_width: int = 384,
                       multiple_of: int = 64):
    """(reference: davis generate_frame_midas.py:118-126)."""
    scale = min(max_width / w, 1.0)
    nw = int(round(w * scale / multiple_of) * multiple_of) or multiple_of
    nh = int(round(h * scale / multiple_of) * multiple_of) or multiple_of
    return nh, nw


def calibration_scale(depth_pred_list: List[np.ndarray],
                      depth_mvs_list: List[np.ndarray]) -> float:
    """Per-track scale: mean over frames of the median prediction/MVS ratio
    on valid pixels (reference: davis generate_frame_midas.py:106-112)."""
    ratios = []
    for pred, mvs in zip(depth_pred_list, depth_mvs_list):
        valid = mvs > 1e-6
        if valid.sum() == 0:
            continue
        ratios.append(np.median(pred[valid] / mvs[valid]))
    return float(np.mean(ratios)) if ratios else 1.0


def resize_frame(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize of ``[H, W, C]`` (align_corners=False, no
    antialias), on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None]
    return resize_bilinear(x, out_hw, False)[0].numpy()


def scale_intrinsics(K: np.ndarray, sy: float, sx: float) -> np.ndarray:
    K = np.asarray(K, np.float32).copy()
    K[0, :] *= sx
    K[1, :] *= sy
    return K


def process_track(
    frames: List[Dict[str, np.ndarray]],
    out_dir: str,
    depth_fn: Callable[[np.ndarray], np.ndarray],
    max_width: int = 384,
    multiple_of: int = 64,
    batch_size: int = 4,
) -> float:
    """Run stage 1 for one track.

    Args:
      frames: list of dicts with ``img [H, W, 3]`` float in [0, 1],
        ``pose_w2c [4, 4]`` (graphics convention), ``intrinsics [3, 3]``,
        optional ``depth_mvs [H, W]`` sparse/dense metric depth and
        ``motion_seg [H, W]``.
      depth_fn: batched depth predictor ``[B, H', W', 3] -> [B, H', W']``.

    Returns the calibration scale applied to the camera translations.
    """
    os.makedirs(out_dir, exist_ok=True)
    h, w = frames[0]["img"].shape[:2]
    nh, nw = working_resolution(h, w, max_width, multiple_of)

    imgs_rs = np.stack([resize_frame(f["img"], (nh, nw)) for f in frames])
    preds = []
    for i in range(0, len(frames), batch_size):
        preds.append(np.asarray(depth_fn(imgs_rs[i:i + batch_size])))
    depth_pred = np.concatenate(preds, axis=0)

    mvs_rs = []
    for f in frames:
        mvs = f.get("depth_mvs")
        if mvs is None:
            mvs_rs.append(np.zeros((nh, nw), np.float32))
        else:
            mvs_rs.append(resize_frame(mvs[..., None], (nh, nw))[..., 0])
    mvs_rs = np.stack(mvs_rs)

    s = calibration_scale(list(depth_pred), list(mvs_rs))

    for i, f in enumerate(frames):
        pose_c2w = flip_world_to_cam(f["pose_w2c"])
        pose_c2w[:3, 3] *= s
        K = scale_intrinsics(f["intrinsics"], nh / h, nw / w)
        seg = f.get("motion_seg")
        seg = (resize_frame(seg[..., None].astype(np.float32), (nh, nw))[..., 0]
               if seg is not None else np.ones((nh, nw), np.float32))
        np.savez(
            join(out_dir, "frame_%05d.npz" % i),
            img=imgs_rs[i].astype(np.float32),
            pose_c2w=pose_c2w.astype(np.float32),
            intrinsics=K,
            depth_pred=depth_pred[i].astype(np.float32),
            depth_mvs=(mvs_rs[i] * s).astype(np.float32)
            if f.get("depth_mvs") is not None
            else depth_pred[i].astype(np.float32),
            img_orig=f["img"].astype(np.float32),
            motion_seg=seg,
        )
    return s


def process_davis_track(
    imgs: List[np.ndarray],
    matrices: np.ndarray,
    K: np.ndarray,
    points_3d: np.ndarray,
    object_masks: List[np.ndarray],
    out_dir: str,
    depth_fn: Callable[[np.ndarray], np.ndarray],
    max_width: int = 384,
    multiple_of: int = 64,
    depth_batch: int = 4,
) -> float:
    """DAVIS stage 1 (reference: scripts/preprocess/davis/
    generate_frame_midas.py:40-147): depth-net inference at the original
    resolution, sparse-point scale calibration, axis flip + w2c->c2w, resize
    with recentred intrinsics. The reference stores the resized depth
    *prediction* as ``depth_mvs`` for DAVIS (line :134), and so does this.

    Args:
      imgs: list of ``[H, W, 3]`` float frames in [0, 1].
      matrices: ``[F, 4, 4]`` raw camera matrices from the triangulation
        file (cam-to-world, graphics axes).
      K: ``[3, 3]`` intrinsics at original resolution.
      points_3d: ``[P, 3]`` triangulated world points.
      object_masks: list of ``[H, W]`` moving-object masks in [0, 1].
    """
    os.makedirs(out_dir, exist_ok=True)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    extr = flip[None] @ np.linalg.inv(matrices)  # [F, 4, 4] w2c, vision axes

    # depth at the original resolution, in batches of one track's frames
    pred_depths = []
    for i in range(0, len(imgs), depth_batch):
        chunk = np.stack(imgs[i:i + depth_batch])
        pred_depths.extend(np.asarray(depth_fn(chunk)))

    s = sparse_calibration_scale(points_3d, extr, K, pred_depths, object_masks)

    h, w = imgs[0].shape[:2]
    sc = min(max_width / w, 1.0)
    tw = max_width if w > max_width else w
    th = int(round(h * sc / multiple_of) * multiple_of)

    for i, im in enumerate(imgs):
        t_g1 = extr[i].copy()
        t_g1[:3, 3] *= s
        pose_c2w = np.linalg.inv(t_g1).astype(np.float32)
        img_rs = resize_frame(im, (th, tw))
        depth_rs = resize_frame(pred_depths[i][..., None], (th, tw))[..., 0]
        seg = resize_frame(object_masks[i][..., None].astype(np.float32),
                           (th, tw))[..., 0]
        seg = np.where(seg > 1e-3, 1.0, 0.0).astype(np.float32)
        np.savez(
            join(out_dir, "frame_%05d.npz" % i),
            img=img_rs.astype(np.float32),
            pose_c2w=pose_c2w,
            intrinsics=recenter_intrinsics(K, (h, w), (th, tw)),
            depth_pred=depth_rs.astype(np.float32),
            depth_mvs=depth_rs.astype(np.float32),
            img_orig=im.astype(np.float32),
            motion_seg=seg,
        )
    return s


def midas_input_size(h: int, w: int, multiple: int = 32):
    """The size MiDaS runs an ``h x w`` frame at: its encoder halves the
    frame five times, so sides that are not multiples of 32 go through it
    resized up to the next multiples (``make_midas_depth_fn``'s
    ``resize``: bicubic there, the depth resized back); ``None`` when both
    already are. Both stage-1 entries (DAVIS, ShutterStock) take it."""
    if h % multiple == 0 and w % multiple == 0:
        return None
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def make_midas_depth_fn(resize: Optional[tuple] = None, device="cuda",
                        n_chips: int = 1) -> Callable:
    """A batched depth predictor ``[B, H, W, 3] in [0, 1] -> [B, H, W]``
    (numpy in and out) on ``device``: MiDaS with the pretrained checkpoint
    at ``runtime/weights.py::MIDAS_PRETRAIN_PATH`` when that file exists,
    else random weights from seed 0. The net is ``depth_fn.net``.

    A batch is padded by cycling its frames to a multiple of ``n_chips``
    and split in order over ``n_chips`` slots (``cuda:0 ..`` above one
    chip; on the CPU, slices through the one net), each slice through its
    device's replica (JAX frames.py:287-337)."""
    from ..models.midas import MidasNet
    from ..runtime.weights import MIDAS_PRETRAIN_PATH, load_midas_checkpoint

    dev = resolve_device(device)
    devices = slot_devices(dev, max(n_chips, 1))
    # float32 as the JAX package computes it: no TF32 in cuDNN convolutions
    # or matrix products (preprocessing builds no train step, which would
    # turn it off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = MidasNet(non_negative=True, normalize_input=True, resize=resize,
                   generator=torch.Generator().manual_seed(0))
    if os.path.isfile(MIDAS_PRETRAIN_PATH):
        load_midas_checkpoint(net, MIDAS_PRETRAIN_PATH)
    net = net.to(devices[0])
    nets = {devices[0]: net}
    for d in devices:
        if d not in nets:
            nets[d] = copy.deepcopy(net).to(d)

    def depth_fn(imgs: np.ndarray) -> np.ndarray:
        arr = np.ascontiguousarray(imgs, np.float32)
        n = arr.shape[0]
        arr = arr[cyclic_pad(n, len(devices))]
        outs = []
        with torch.no_grad():
            for d, part in zip(devices, np.split(arr, len(devices))):
                with on_device(d):
                    outs.append(nets[d](torch.from_numpy(part).to(d)))
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    depth_fn.net = net
    return depth_fn
