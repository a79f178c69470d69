"""ShutterStock preprocessing entry: ``python -m
dynamic_video_depth_tpu_torch.preprocess.run_shutterstock`` (counterpart of
``scripts/preprocess/run_shutterstock.py``; reference scripts/preprocess/
shutterstock/*).

Stage 1 reads per-frame h5 files with ``prediction/{img, mvs_depth,
T_1_G, K}`` (``load_shutterstock_h5``, the only code that needs ``h5py``)
and writes the reference-layout frame npz files
(``process_shutterstock_track``): MiDaS depth on ``--device``, the scale
from the dense MVS depth, the poses' translations rescaled, the
intrinsics recentred, and unlike DAVIS the scaled MVS depth kept as
``depth_mvs``. The working resolution has its longest side at most 384
and both sides multiples of 32 (``get_im_size``); MiDaS takes frames
whose sides are not multiples of 32 at the next multiples
(``midas_input_size``; the JAX entry runs it on the frames as they are,
which such frames fail). Stages 2-3 are the
DAVIS entry's: RAFT flows and masks, then the packed pairs. ``--n_chips
N`` (above 1) splits stage 1's batches of ``max(N, 4)`` frames and stage
2's batches of N pairs over ``cuda:0 .. N-1``.

Example::

  python -m dynamic_video_depth_tpu_torch.preprocess.run_shutterstock \\
      --raw_root raw --track 0001 --out_root datafiles/shutterstock \\
      --gaps 1,2 --device cpu
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import join
from typing import Callable, Optional, Sequence

import numpy as np

from . import flows, frames, pairs


def get_im_size(h: int, w: int, dim_max: int = 384, multiple: int = 32):
    """Working ``(height, width)`` of an ``h x w`` frame (reference:
    shutterstock generate_frame_midas.py:85-105)."""
    if w > h:
        if w > dim_max:
            sc, tw = dim_max / w, dim_max
        else:
            tw = int(np.floor(w / multiple) * multiple)
            sc = tw / w
        th = int(np.round((h * sc) / multiple) * multiple)
    else:
        if h > dim_max:
            sc, th = dim_max / h, dim_max
        else:
            th = int(np.floor(h / multiple) * multiple)
            sc = th / h
        tw = int(np.round((w * sc) / multiple) * multiple)
    return th, tw


def midas_input_size(h: int, w: int, multiple: int = 32):
    """The size MiDaS runs an ``h x w`` frame at: its encoder halves the
    frame five times, so sides that are not multiples of 32 go through it
    resized up to the next multiples (``make_midas_depth_fn``'s
    ``resize``: bicubic there, the depth resized back); ``None`` when both
    already are."""
    if h % multiple == 0 and w % multiple == 0:
        return None
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def load_shutterstock_h5(files: Sequence[str]):
    """The frames ``[H, W, 3]``, MVS depths ``[H, W]`` (float32 lists),
    ``T_1_G`` ``[N, 4, 4]`` (float64) and ``K`` ``[N, 3, 3]`` (float32) of
    per-frame h5 files."""
    import h5py

    imgs, mvs, t_1_g, K = [], [], [], []
    for f in files:
        with h5py.File(f, "r") as hf:
            imgs.append(np.asarray(hf["prediction/img"], np.float32))
            mvs.append(np.asarray(hf["prediction/mvs_depth"], np.float32))
            t_1_g.append(np.asarray(hf["prediction/T_1_G"], np.float64))
            K.append(np.asarray(hf["prediction/K"], np.float32))
    return imgs, mvs, np.stack(t_1_g), np.stack(K)


def process_shutterstock_track(imgs, mvs, T_1_G, K, out_dir: str,
                               depth_fn: Callable[[np.ndarray], np.ndarray],
                               depth_batch: int = 4) -> float:
    """Stage 1 on arrays in memory: ``depth_fn`` over the frames in
    batches of ``depth_batch``, the scale ``s`` (the mean over frames of
    the median ratio of predicted to MVS depth where the MVS depth is
    valid; reference :154-161), then one npz a frame with the pose
    ``inv(T_1_G)`` of a translation scaled by ``s``. Returns ``s``."""
    os.makedirs(out_dir, exist_ok=True)
    preds = []
    for i in range(0, len(imgs), depth_batch):
        preds.extend(np.asarray(depth_fn(np.stack(imgs[i:i + depth_batch]))))

    scales = []
    for p, m in zip(preds, mvs):
        iy, ix = np.where(m > 1e-3)
        if iy.size:
            scales.append(np.median(p[iy, ix] / m[iy, ix]))
    s = float(np.mean(scales)) if scales else 1.0

    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        th, tw = get_im_size(h, w)
        t_g1 = np.asarray(T_1_G[i], np.float64).copy()
        t_g1[:3, 3] *= s
        np.savez(
            join(out_dir, "frame_%05d.npz" % i),
            img=frames.resize_frame(img, (th, tw)).astype(np.float32),
            pose_c2w=np.linalg.inv(t_g1).astype(np.float32),
            intrinsics=frames.recenter_intrinsics(
                np.asarray(K[i], np.float32), (h, w), (th, tw)),
            depth_pred=frames.resize_frame(preds[i][..., None],
                                           (th, tw))[..., 0],
            depth_mvs=frames.resize_frame((mvs[i] * s)[..., None],
                                          (th, tw))[..., 0],
            img_orig=img,
        )
    return s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.preprocess."
             "run_shutterstock")
    a = p.add_argument
    a("--raw_root", required=True, help="dir of <track>/*.h5 frame files")
    a("--track", required=True)
    a("--out_root", default="./datafiles/shutterstock")
    a("--gaps", default="1,2,3,4,5,6,7,8")
    a("--raft_ckpt", default="./third_party/RAFT/models/raft-sintel.pth")
    a("--stage", default="all", choices=["all", "frames", "flows", "pairs"])
    a("--device", default="cuda", help="torch device; 'cuda' needs a GPU")
    a("--n_chips", type=int, default=0,
      help="split stage-1 MiDaS / stage-2 RAFT batches over this many "
           "devices (0 = serial single-device)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    frame_dir = join(args.out_root, "frames_midas", args.track)
    flow_dir = join(args.out_root, "flow_pairs", args.track)
    seq_dir = join(args.out_root, "sequences_select_pairs_midas", args.track,
                   "001")
    gaps = [int(g) for g in args.gaps.split(",")]
    n_chips = max(args.n_chips, 1)

    if args.stage in ("all", "frames"):
        files = sorted(glob(join(args.raw_root, args.track, "*.h5")),
                       key=lambda f: int(f.split("_")[-1].split(".")[0]))
        imgs, mvs, t_1_g, K = load_shutterstock_h5(files)
        depth_fn = frames.make_midas_depth_fn(
            resize=midas_input_size(*imgs[0].shape[:2]), device=args.device,
            n_chips=n_chips)
        s = process_shutterstock_track(imgs, mvs, t_1_g, K, frame_dir,
                                       depth_fn,
                                       depth_batch=max(args.n_chips, 4))
        print(f"stage 1 done: {len(files)} frames, scale {s:.4f}",
              flush=True)

    if args.stage in ("all", "flows"):
        if not os.path.isfile(args.raft_ckpt):
            print(f"stage 2: no RAFT checkpoint at {args.raft_ckpt}; random "
                  "weights", flush=True)
        flows.process_track(frame_dir, flow_dir, gaps=gaps,
                            ckpt_path=args.raft_ckpt, device=args.device,
                            n_chips=n_chips)
        print("stage 2 done", flush=True)

    if args.stage in ("all", "pairs"):
        pairs.pack_track(frame_dir, flow_dir, seq_dir, gaps=gaps)
        print("stage 3 done", flush=True)


if __name__ == "__main__":
    main()
