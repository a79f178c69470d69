"""Test entry: ``python -m dynamic_video_depth_tpu_torch.test``
(counterpart of the JAX package's ``test.py``; reference test.py and
models/video_base.py:128-272).

Rehydrates a run's options from its ``opt.json`` (the net, the dataset,
``davis_sequence`` or ``shutterstock``, and the depth net's compute dtype
among them), loads ``best.pt`` (or ``nets/%04d.pt`` with ``--epoch N``) and
runs the refined depth net and the one-step scene flow over every frame of
the track on ``--device`` (default ``cuda``). With ``--n_chips N`` the
frames go in groups of N, frame j of a group on its own device's replica
of the nets (``cuda:j``; on the CPU the one replica serves every slot),
the last group padded with its last frame (JAX test.py:90-127); the
outputs are those of ``--n_chips 1`` and each frame's time is its group's
over the group's frames. Into
``{output_dir}/epoch{best|%04d}_test/`` it writes per frame
``batch%04d.npz`` (the JAX package's schema) and the visualizer's PNGs and
``index.html``; beside that directory the report
``epoch{best|%04d}_test.html`` and ``epoch{best|%04d}_test.json`` (the
disparity loss against the initial depth, the depth metrics against the
ground truth, per-frame times and the kernel launches of the pass). The
comparison, RGB and temporal-slice figures need matplotlib, the videos
ffmpeg; where either is missing one line says so and the rest is written.

Example::

  python -m dynamic_video_depth_tpu_torch.test \\
      --checkpoint_path checkpoints/<run>/0 --output_dir checkpoints/<run>/0/test
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import time
from argparse import Namespace
from os.path import dirname, join
from typing import Optional, Sequence

import numpy as np
import torch

from .data import get_dataset
from .data.batches import to_device
from .ops import cuda as cuda_kernels
from .runtime import config
from .runtime.checkpoint import load_checkpoint, load_opt
from .runtime.device import on_device, resolve_device, slot_devices
from .models import get_model
from .train.losses import disparity_vali_loss
from .utils.html import Webpage
from .utils.metrics import depth_metrics
from .utils.visualizer import HTMLVisualizer


def checkpoint_file(opt_test):
    """(checkpoint file, run directory) of ``--checkpoint_path`` and
    ``--epoch``."""
    path = opt_test.checkpoint_path
    if path.endswith(".pt"):
        return path, dirname(path)
    name = ("best.pt" if opt_test.epoch < 0
            else join("nets", "%04d.pt" % opt_test.epoch))
    return join(path, name), path


def frame_pack(batch, pred) -> dict:
    """One frame's dump in the JAX package's test schema (test.py:141-151;
    reference pack_output and test_on_batch, models/video_base.py:105-155)."""
    return {
        "batch_size": np.asarray([1]),
        "img_1": batch["img"], "img_2": batch["img"],
        "depth": pred["depth"], "sf_1_2": pred["sf_1_2"],
        "depth_nn": batch["depth_pred"], "depth_gt": batch["depth_mvs"],
        "cam_c2w": batch["cam_c2w"], "K": batch["K"],
        "pair_path": np.asarray(batch["pair_path"]),
    }


def draw_figures(outdir, depth_pred, depth_nn, depth_gt, imgs) -> bool:
    """``compare_%04d.png`` (refined, initial and ground-truth inverse
    depth), ``rgb_%04d.png`` and ``temporal_slice_%04d.png`` (JAX
    test.py:168-229); ``False``, with one printed line, without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not installed: the compare, rgb and temporal "
              "slice figures were not drawn", flush=True)
        return False

    pred_min, pred_max = depth_pred.min(), depth_pred.max()
    mask_valid = np.where(depth_gt > 1e-8, 1.0, 0.0)

    def colorbar_panel(ax, im):
        cbar = plt.colorbar(im, ax=ax, fraction=0.048 * 0.5, pad=0.01)
        cbar.ax.yaxis.set_tick_params(color="w", labelsize=10)
        plt.setp(plt.getp(cbar.ax.axes, "yticklabels"), color="w")

    for i in range(depth_pred.shape[0]):
        fig, axes = plt.subplots(1, 3, figsize=(15, 5), facecolor="black")
        panels = [("Refined", 1.0 / depth_pred[i]),
                  ("Initial", 1.0 / depth_nn[i]),
                  ("GT", mask_valid[i] / (depth_gt[i] + 1e-8))]
        for ax, (title, data) in zip(axes, panels):
            im = ax.imshow(data, cmap="turbo", vmax=1.0 / pred_min,
                           vmin=1.0 / pred_max)
            ax.set_title(title, color="w")
            ax.axis("off")
            colorbar_panel(ax, im)
        fig.savefig(join(outdir, "compare_%04d.png" % i),
                    bbox_inches="tight", facecolor="black")
        plt.close(fig)

        plt.imshow(np.clip(imgs[i], 0, 1))
        plt.axis("off")
        plt.savefig(join(outdir, "rgb_%04d.png" % i), bbox_inches="tight",
                    facecolor="black")
        plt.close()

    # temporal slices (reference rows 120..139, clipped to the height)
    h = depth_pred.shape[1]
    rows = range(min(120, h - 21), min(140, h - 1))
    for ridx, r in enumerate(rows):
        fig, axes = plt.subplots(1, 2, figsize=(12, 4), facecolor="black")
        for ax, (title, data) in zip(
                axes, [("Refined", 1.0 / depth_pred[:, r, :]),
                       ("Initial", 1.0 / depth_nn[:, r, :])]):
            im = ax.imshow(data, cmap="turbo")
            ax.set_title(title, color="w")
            ax.axis("off")
            colorbar_panel(ax, im)
        fig.savefig(join(outdir, "temporal_slice_%04d.png" % ridx),
                    bbox_inches="tight", facecolor="black")
        plt.close(fig)
    return True


def render_videos(outdir, vid: str, vid_t: str) -> bool:
    """The compare and temporal-slice videos with ffmpeg, where it is
    installed; ``False``, with one printed line, where it is not."""
    if shutil.which("ffmpeg") is None:
        print("ffmpeg is not installed: the videos were not rendered",
              flush=True)
        return False
    tpl = ("ffmpeg -y -r {rate} -i {tpl} -vcodec libx264 -crf 25 -pix_fmt "
           'yuv420p -vf "pad=ceil(iw/2)*2:ceil(ih/2)*2" {out} > /dev/null 2>&1')
    subprocess.call(tpl.format(rate=30, tpl=join(outdir, "compare_%04d.png"),
                               out=vid), shell=True)
    subprocess.call(tpl.format(rate=2,
                               tpl=join(outdir, "temporal_slice_%04d.png"),
                               out=vid_t), shell=True)
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the test pass; returns the summary it writes as json."""
    opt_test = config.parse_test(argv)
    device = resolve_device(opt_test.device)
    n_par = max(1, opt_test.n_chips)
    devices = slot_devices(device, n_par)
    ckpt_file, ckpt_dir = checkpoint_file(opt_test)
    opt_train = Namespace(**load_opt(ckpt_dir))
    if opt_test.data_root:
        opt_train.data_root = opt_test.data_root
    for k in ("net", "dataset"):
        v = getattr(opt_test, k)
        if v and v != getattr(opt_train, k, v):
            print(f"Warning: --{k} {v} differs from the checkpoint's "
                  f"{getattr(opt_train, k)}; using the checkpoint's")

    dataset = get_dataset(opt_train.dataset)(opt_train, "vali")
    if len(dataset) == 0:
        raise SystemExit("no validation frames found")
    Model = get_model(opt_train.net)
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = Model(opt_train, device=d, pretrained=False)
            meta = load_checkpoint(ckpt_file, replicas[d].step,
                                   load_optimizer=False)
    print(f"Loaded {ckpt_file} (epoch {meta.get('epoch', '?')})", flush=True)

    epoch_string = "best" if opt_test.epoch < 0 else "%04d" % opt_test.epoch
    outdir = join(opt_test.output_dir, f"epoch{epoch_string}_test")
    if os.path.isdir(outdir) and os.listdir(outdir):
        # the reference refuses to replace a render set (test.py:55-60)
        if not opt_test.overwrite:
            raise SystemExit(f"{outdir} already exists; pass --overwrite to "
                             "replace it")
        shutil.rmtree(outdir)
    os.makedirs(outdir, exist_ok=True)
    visualizer = HTMLVisualizer(n_workers=opt_test.vis_workers)

    depth_pred, depth_nn, depth_gt, imgs = [], [], [], []
    predict_ms, frame_ms, losses = [], [], []
    cuda_kernels.reset_launches()
    t_loop = time.perf_counter()
    try:
        for lo in range(0, len(dataset), n_par):
            idxs = list(range(lo, min(lo + n_par, len(dataset))))
            group = [dataset[i] for i in idxs]
            padded = group + [group[-1]] * (n_par - len(group))
            t0 = time.perf_counter()
            devs = [to_device(b, d) for b, d in zip(padded, devices)]
            preds_t = []
            for d, dev in zip(devices, devs):
                with on_device(d):
                    preds_t.append(replicas[d].step.predict(dev))
            for d in set(devices):
                _sync(d)
            group_ms = 1e3 * (time.perf_counter() - t0) / len(group)
            for i, batch, dev, pred_t in zip(idxs, group, devs, preds_t):
                t1 = time.perf_counter()
                losses.append(disparity_vali_loss(pred_t["depth"],
                                                  dev["depth_mvs"]))
                pred = {k: v.cpu().numpy() for k, v in pred_t.items()}
                pack = frame_pack(batch, pred)
                np.savez(join(outdir, "batch%04d" % i), **pack)
                visualizer.visualize(pack, i, outdir)
                frame_ms.append(group_ms + 1e3 * (time.perf_counter() - t1))
                predict_ms.append(group_ms)
                depth_pred.append(pred["depth"][0])
                depth_nn.append(batch["depth_pred"][0])
                depth_gt.append(batch["depth_mvs"][0])
                imgs.append(batch["img"][0])
        visualizer.flush()
    finally:
        visualizer.close()
    loop_seconds = time.perf_counter() - t_loop
    launches = cuda_kernels.launch_counts()
    test_loss = float(np.mean(np.asarray(
        [float(v) for v in losses], np.float64)))
    print(f"disparity loss vs init: {test_loss:.6g}")
    metrics = depth_metrics(np.stack(depth_pred), np.stack(depth_gt))
    print("depth metrics vs gt:",
          " ".join(f"{k}={v:.4g}" for k, v in metrics.items()), flush=True)

    figures = draw_figures(outdir, np.stack(depth_pred), np.stack(depth_nn),
                           np.stack(depth_gt), np.stack(imgs))
    vid = join(dirname(outdir), f"epoch{epoch_string}_test.mp4")
    vid_t = join(dirname(outdir), f"epoch{epoch_string}_test_temporal.mp4")
    videos = figures and render_videos(outdir, vid, vid_t)

    web = Webpage()
    web.add_video(os.path.basename(vid),
                  title=f"Disparity loss {test_loss:.6g}")
    web.add_video(os.path.basename(vid_t), title="temporal slices")
    web.save(join(dirname(outdir), f"epoch{epoch_string}_test.html"))

    later = predict_ms[1:] or predict_ms
    summary = {
        "checkpoint": ckpt_file, "epoch": meta.get("epoch"),
        "device": str(device), "n_chips": n_par, "frames": len(dataset),
        "disparity_loss": test_loss, "depth_metrics": metrics,
        "predict_ms": predict_ms, "frame_ms": frame_ms,
        "median_predict_ms": statistics.median(later),
        "median_frame_ms": statistics.median(frame_ms[1:] or frame_ms),
        "loop_seconds": loop_seconds, "launches": launches,
        "figures": figures, "videos": videos,
    }
    with open(join(dirname(outdir), f"epoch{epoch_string}_test.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    print(f"Wrote results to {outdir}", flush=True)
    return summary


if __name__ == "__main__":
    main()
