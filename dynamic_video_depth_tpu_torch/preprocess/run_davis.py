"""DAVIS preprocessing entry: ``python -m dynamic_video_depth_tpu_torch.
preprocess`` (counterpart of ``scripts/preprocess/run_davis.py``; reference
scripts/preprocess/davis/{generate_frame_midas,generate_flows,
generate_sequence_midas}.py).

Reads the raw inputs:
  <raw_root>/JPEGImages/1080p/<track>/*.jpg        (frames)
  <raw_root>/Annotations/1080p/<track>/*.png       (moving-object masks)
  <raw_root>/triangulation/<track>.intrinsics.txt  (fx fy cx cy per frame)
  <raw_root>/triangulation/<track>.matrices.txt    (4x4 camera matrices)
  <raw_root>/triangulation/<track>.obj             (triangulated points)
and writes <out_root>/{frames_midas,flow_pairs,sequences_select_pairs_midas}/
<track>/... in the reference layout. MiDaS (stage 1) and RAFT (stage 2) run
on ``--device``; MiDaS takes frames whose sides are not multiples of 32
(DAVIS's raw 1080x1920) at the next multiples (``frames.midas_input_size``:
1088x1920) and resizes the depth back, where the JAX entry runs the raw
frames and fails in the decoder's skip connections (136 against 135
rows). Each of the two nets loads its pretrained torch checkpoint when
the file exists and otherwise runs random weights from seed 0. ``--n_chips N``
(above 1) splits stage 1's batches of ``max(N, 4)`` frames and stage 2's
batches of N pairs over ``cuda:0 .. N-1`` (JAX scripts/preprocess/
run_davis.py:62-94); the files are those of a serial run.

Example (the tiny CPU run of the README)::

  python -m dynamic_video_depth_tpu_torch.preprocess --raw_root raw \\
      --track dog --out_root datafiles/davis_processed --gaps 1,2 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import join
from typing import Optional, Sequence

import numpy as np

from . import flows, frames, pairs


def load_davis_track(raw_root: str, track: str):
    """Raw DAVIS inputs in the reference layout (reference: scripts/
    preprocess/davis/generate_frame_midas.py:40-56): frames, per-frame
    moving-object masks, triangulation intrinsics, matrices and points."""
    from PIL import Image

    frame_files = sorted(glob(join(raw_root, "JPEGImages", "1080p", track,
                                   "*.jpg")))
    mask_files = sorted(glob(join(raw_root, "Annotations", "1080p", track,
                                  "*.png")))
    tri = join(raw_root, "triangulation")
    fx, fy, cx, cy = np.loadtxt(join(tri, f"{track}.intrinsics.txt"))[0][1:]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    matrices = np.loadtxt(join(tri, f"{track}.matrices.txt"))[:, 1:]
    matrices = matrices.reshape(-1, 4, 4)
    points_3d = frames.load_obj_vertices(join(tri, f"{track}.obj"))
    imgs = [np.asarray(Image.open(f), np.float32) / 255.0
            for f in frame_files]
    masks = [np.asarray(Image.open(f).convert("RGB"), np.float32)[:, :, 0]
             / 255.0 for f in mask_files]
    return imgs, matrices, K, points_3d, masks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.preprocess")
    a = p.add_argument
    a("--raw_root", required=True)
    a("--track", required=True)
    a("--out_root", default="./datafiles/davis_processed")
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
        imgs, matrices, K, points_3d, masks = load_davis_track(
            args.raw_root, args.track)
        depth_fn = frames.make_midas_depth_fn(
            resize=frames.midas_input_size(*imgs[0].shape[:2]),
            device=args.device, n_chips=n_chips)
        s = frames.process_davis_track(imgs, matrices, K, points_3d, masks,
                                       frame_dir, depth_fn, max_width=384,
                                       multiple_of=64,
                                       depth_batch=max(args.n_chips, 4))
        print(f"stage 1 done: {len(imgs)} frames, scale {s:.4f}", flush=True)

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
