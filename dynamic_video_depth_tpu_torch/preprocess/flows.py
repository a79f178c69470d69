"""Preprocessing stage 2: RAFT flows and fwd/bwd-consistency occlusion masks
(counterpart of ``dynamic_video_depth_tpu/preprocess/flows.py``; reference
scripts/preprocess/davis/generate_flows.py).

Per (frame, gap) pair:
1. RAFT forward and backward flow at ``RAFT_RES`` (``RAFT_ITERS``
   iterations), both directions in one batch of two,
2. bicubic resize of the flows to the working resolution with per-axis
   magnitude scaling (reference :44-54),
3. occlusion mask = (fwd/bwd consistency error > 1 px) OR out of bounds
   (reference :139-148),
4. save ``flowpair_xxxxx_yyyyy.npz {flow_1_2, flow_2_1, mask_1, mask_2,
   frame_id_1, frame_id_2}``.
Steps 1-3 and the input resize run on the device as torch tensors; the
flows and masks come to the host once, for the file. ``RAFT_RES`` and
``RAFT_ITERS`` are read at each call, so a caller may shrink RAFT by
setting them.
"""

from __future__ import annotations

import copy
import os
from collections import OrderedDict
from glob import glob
from os.path import join
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.grid_sample import backward_warp
from ..ops.resize import resize_bicubic, resize_bilinear
from ..runtime.device import (cyclic_pad, on_device, resolve_device,
                              slot_devices)

RAFT_RES = (288, 512)
RAFT_ITERS = 20


def resize_flow(flow: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize of ``flow [H, W, 2]`` with magnitude scaling
    (reference :44-54)."""
    h, w = flow.shape[:2]
    nh, nw = out_hw
    out = resize_bicubic(flow[None], (nh, nw), False)[0]
    return out * flow.new_tensor([nw / float(w), nh / float(h)])


def oob_mask(flow: torch.Tensor) -> torch.Tensor:
    """Targets leaving the frame (reference :57-66), 0/1 as ``flow``'s
    dtype. ``x + fx < 0`` is tested as ``fx < -x`` against the integer
    bounds: exact, as the reference's float64 sum is."""
    h, w = flow.shape[:2]
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    fx, fy = flow[..., 0], flow[..., 1]
    m = (fx < -xx) | (fx > (w - 1) - xx) | (fy < -yy) | (fy > (h - 1) - yy)
    return m.to(flow.dtype)


def backward_flow_warp(field: torch.Tensor,
                       flow_1_2: torch.Tensor) -> torch.Tensor:
    """Sample ``field [H, W, C]`` at pixel + flow (border clamp,
    bilinear)."""
    return backward_warp(field[None], flow_1_2[None])[0]


def occlusion_masks(flow_1_2: torch.Tensor, flow_2_1: torch.Tensor,
                    thresh=1.0):
    """(reference :139-148): mask_k = 1 (uint8) where pixel of frame k is
    occluded."""

    def mask(fwd, bwd):
        d = backward_flow_warp(fwd, bwd) + bwd
        err = (d * d).sum(-1).sqrt()
        return ((err > thresh) | (oob_mask(bwd) > 0)).to(torch.uint8)

    return mask(flow_1_2, flow_2_1), mask(flow_2_1, flow_1_2)


def make_raft_flow_batch_fn(ckpt_path: str | None = None,
                            device="cuda", n_chips: int = 1) -> Callable:
    """Batched RAFT predictor ``(im1s, im2s) [N, H, W, 3] -> (f12s, f21s)``
    on ``device`` (tensors there, images in [0, 255]). Both directions ride
    one batch of ``2N``. The official checkpoint at ``ckpt_path`` is loaded
    when that file exists (``runtime/weights.py::load_raft_checkpoint``,
    which raises on a key it does not consume); else random weights from
    seed 0.

    The ``N`` pairs are padded by cycling them to a multiple of
    ``n_chips`` and split in order over ``n_chips`` slots (``cuda:0 ..``
    above one chip; on the CPU, slices through the one net), each slice's
    pairs, both directions, through its device's replica (JAX
    flows.py:137-182 splits the ``2N`` rows instead; a slice of whole
    pairs gives each pair the batch a serial call gives it, and so the
    serial call's flows, bit for bit). The flows come back on
    ``device``."""
    from ..models.raft import RAFT
    from ..runtime.weights import load_raft_checkpoint

    device = resolve_device(device)
    devices = slot_devices(device, max(n_chips, 1))
    # float32 as the JAX package computes it: no TF32 in cuDNN convolutions
    # or matrix products, whose error would grow over the iterations
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = RAFT(generator=torch.Generator().manual_seed(0))
    if ckpt_path and os.path.isfile(ckpt_path):
        load_raft_checkpoint(net, ckpt_path)
    net = net.to(devices[0])
    nets = {devices[0]: net}
    for d in devices:
        if d not in nets:
            nets[d] = copy.deepcopy(net).to(d)

    def flow_fn(im1s: torch.Tensor, im2s: torch.Tensor):
        n = im1s.shape[0]
        rows = torch.tensor(cyclic_pad(n, len(devices)), device=im1s.device)
        outs = []
        with torch.no_grad():
            for d, a, b in zip(devices, im1s[rows].chunk(len(devices)),
                               im2s[rows].chunk(len(devices))):
                a, b = a.to(d), b.to(d)
                with on_device(d):
                    outs.append(nets[d](torch.cat([a, b]), torch.cat([b, a]),
                                        iters=RAFT_ITERS)[1])
        fwd = torch.cat([o[:len(o) // 2].to(device) for o in outs])
        bwd = torch.cat([o[len(o) // 2:].to(device) for o in outs])
        return fwd[:n], bwd[:n]

    return flow_fn


def make_raft_flow_fn(ckpt_path: str | None = None,
                      device="cuda") -> Callable:
    """One pair: ``(im1, im2) [H, W, 3] -> (flow_1_2, flow_2_1) [H, W, 2]``,
    both directions in one batch of two."""
    batch_fn = make_raft_flow_batch_fn(ckpt_path, device)

    def flow_fn(im1: torch.Tensor, im2: torch.Tensor):
        f12, f21 = batch_fn(im1[None], im2[None])
        return f12[0], f21[0]

    return flow_fn


def _prep_raft_input(frame_data: dict, device="cuda") -> torch.Tensor:
    """Original-resolution frame -> ``[H, W, 3]`` float image in [0, 255]
    at ``RAFT_RES`` on ``device`` (reference: generate_flows.py:120-122):
    bilinear, align_corners=False, no antialias."""
    device = resolve_device(device)
    img = torch.from_numpy(np.asarray(frame_data["img_orig"], np.float32))
    img = img.to(device) * 255.0
    return resize_bilinear(img[None], RAFT_RES, False)[0]


def postprocess_pair(f12: torch.Tensor, f21: torch.Tensor, out_hw) -> dict:
    """RAFT-resolution flows -> working-resolution flows + occlusion masks,
    computed where the flows are and returned as numpy."""
    flow_1_2 = resize_flow(f12, out_hw)
    flow_2_1 = resize_flow(f21, out_hw)
    mask_1, mask_2 = occlusion_masks(flow_1_2, flow_2_1)
    out = {"flow_1_2": flow_1_2, "flow_2_1": flow_2_1, "mask_1": mask_1,
           "mask_2": mask_2}
    return {k: v.cpu().numpy() for k, v in out.items()}


def generate_pair(flow_fn, im1_data: dict, im2_data: dict, device="cuda"):
    """One pair's flows + masks at the frame working resolution; ``flow_fn``
    runs on ``device``."""
    h, w = im1_data["img"].shape[:2]
    f12, f21 = flow_fn(_prep_raft_input(im1_data, device),
                       _prep_raft_input(im2_data, device))
    return postprocess_pair(f12, f21, (h, w))


def process_track(frame_dir: str, out_dir: str,
                  gaps: Sequence[int] = (1, 2, 3, 4, 5, 6, 7, 8),
                  ckpt_path: str | None = None, device="cuda",
                  n_chips: int = 1):
    """All (frame, gap) pairs of the track (reference :165-178), gap after
    gap, ``n_chips`` pairs a RAFT call on ``device``: one pair a call on
    one chip, and over ``n_chips`` chips a call's pairs split over them
    (JAX flows.py:231-274)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(glob(join(frame_dir, "frame_*.npz")))
    n_chips = max(n_chips, 1)
    flow_fn = make_raft_flow_batch_fn(ckpt_path, device, n_chips)

    def load(i):
        return dict(np.load(files[i], allow_pickle=True))

    h, w = load(0)["img"].shape[:2] if files else (0, 0)
    # bounded LRU of RAFT-resolution frames on the device: pairs reference
    # each frame across all gaps, but an unbounded cache holds the whole
    # track (~1 GB for a reference-scale track)
    prepped: OrderedDict = OrderedDict()
    max_cached = max(64, 4 * n_chips)

    def prep(i):
        if i in prepped:
            prepped.move_to_end(i)
        else:
            prepped[i] = _prep_raft_input(load(i), device)
            while len(prepped) > max_cached:
                prepped.popitem(last=False)
        return prepped[i]

    pairs = [(i, i + g) for g in gaps for i in range(len(files) - g)]
    for lo in range(0, len(pairs), n_chips):
        chunk = pairs[lo:lo + n_chips]
        f12s, f21s = flow_fn(torch.stack([prep(i) for i, _ in chunk]),
                             torch.stack([prep(j) for _, j in chunk]))
        for (i, j), f12, f21 in zip(chunk, f12s, f21s):
            out = postprocess_pair(f12, f21, (h, w))
            out["frame_id_1"] = i
            out["frame_id_2"] = j
            np.savez(join(out_dir, f"flowpair_{i:05d}_{j:05d}.npz"), **out)
