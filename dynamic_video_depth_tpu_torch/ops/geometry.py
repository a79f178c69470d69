"""Camera geometry (counterpart of
``dynamic_video_depth_tpu/ops/geometry.py``; reference
losses/scene_flow_projection.py).

Channel-last: depth ``[B,H,W]``, flow ``[B,H,W,2]``, points ``[B,H,W,3]``.
Every 3x3 product is written as a broadcast multiply and a sum over the last
axis, so it runs in plain float32 whatever the TF32 settings are (the
counterpart of the JAX package's ``Precision.HIGHEST`` pin: reduced-precision
geometry costs about a pixel).

The train step runs the fused stages, ``depth_warp_stage`` and
``projection_stage``. The reference's unfused loss modules are here too:
``project_displacement``, ``flow_by_depth`` (a 3-channel warp of the
frame-2 world points), ``scene_flow_projection`` (a 4-channel warp of
``[p2_camera_2, depth_2]``; the reference's unused 2->1 projection is not
computed, as in the JAX package) and ``rigidity_loss``. Every warp goes
through kernel A's wrapper: its plain version on CPU tensors, the kernel on
CUDA tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .camera import Camera
from .coords import pixel_coords, pixel_coords_homogeneous
from .cuda.warp_kernel import backward_warp

_EPS_PROJ = 1e-8
_Z_DEGENERATE = 1e-3


def _apply(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``m [B,3,3] @ pts[..., :, None]`` for ``pts [B,H,W,3]`` (or
    ``[H,W,3]``, shared across the batch), in float32 FMAs."""
    if pts.dim() == 3:
        pts = pts[None]
    return (m[:, None, None, :, :] * pts[..., None, :]).sum(-1)


def unproject_camera(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Depth map -> camera-frame point cloud ``d * K^-1 [x, y, 1]``."""
    _, h, w = depth.shape
    pix = pixel_coords_homogeneous(h, w, depth.dtype, depth.device)
    return depth[..., None] * _apply(cam.K_inv, pix)


def camera_to_world(cam_pts: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Camera-frame points -> world points ``R_c2w @ p + t``."""
    return _apply(cam.R_c2w, cam_pts) + cam.t[:, None, None, :]


def unproject(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Depth map ``[B,H,W]`` -> world points ``[B,H,W,3]``."""
    return camera_to_world(unproject_camera(depth, cam), cam)


def world_to_camera(points: torch.Tensor, cam: Camera) -> torch.Tensor:
    """World points -> camera-frame points ``R_c2w^T @ (p - t)``."""
    rel = points - cam.t[:, None, None, :]
    return _apply(cam.R_c2w.transpose(-1, -2), rel)


def project(points: torch.Tensor, cam: Camera):
    """World points -> (pixel coordinates ``[B,H,W,2]``, camera-frame points
    ``[B,H,W,3]``). Points with projected z < 1e-3 fall back to their own
    pixel so they contribute zero displacement."""
    _, h, w, _ = points.shape
    cam_pts = world_to_camera(points, cam)
    img = _apply(cam.K, cam_pts)
    z = img[..., 2:3]
    pix = img[..., :2] / (z + _EPS_PROJ)
    base = pixel_coords(h, w, points.dtype, points.device)[None]
    return torch.where(z < _Z_DEGENERATE, base, pix), cam_pts


def project_displacement(points: torch.Tensor, cam: Camera) -> torch.Tensor:
    """World points -> each point's displacement from its own pixel
    (reference ``project_ptcld``, losses/scene_flow_projection.py:21-44)."""
    _, h, w, _ = points.shape
    pix, _ = project(points, cam)
    return pix - pixel_coords(h, w, points.dtype, points.device)[None]


def flow_by_depth(depth_1, depth_2, flow_1_2, cam_1: Camera,
                  cam_2: Camera) -> Dict[str, torch.Tensor]:
    """The flow implied by ``depth_1`` and the egomotion, and the scene flow
    implied by the observed flow (reference ``flow_by_depth``,
    losses/scene_flow_projection.py:95-153): ``dflow_1_2``, ``sf_by_depth``,
    ``warped_global_p2`` and ``global_p1``."""
    global_p1 = unproject(depth_1, cam_1)
    global_p2 = unproject(depth_2, cam_2)
    warped_global_p2 = backward_warp(global_p2, flow_1_2)
    return {
        "dflow_1_2": project_displacement(global_p1, cam_2),
        "sf_by_depth": warped_global_p2 - global_p1,
        "warped_global_p2": warped_global_p2,
        "global_p1": global_p1,
    }


def scene_flow_projection(depth_1, depth_2, flow_1_2, cam_1: Camera,
                          cam_2: Camera,
                          sflow_1_2) -> Dict[str, torch.Tensor]:
    """Unproject, advect by the scene flow, reproject into camera 2
    (reference ``scene_flow_projection_slack``,
    losses/scene_flow_projection.py:204-278): the dict that
    ``projection_stage`` completes, written out on its own. The observed
    flow warps ``[p2_camera_2, depth_2]`` in one 4-channel warp."""
    _, h, w = depth_1.shape
    base = pixel_coords(h, w, depth_1.dtype, depth_1.device)[None]
    pix_h = pixel_coords_homogeneous(h, w, depth_1.dtype, depth_1.device)
    p1_camera_1 = depth_1[..., None] * _apply(cam_1.K_inv, pix_h)
    p2_camera_2 = depth_2[..., None] * _apply(cam_2.K_inv, pix_h)
    global_p1 = _apply(cam_1.R_c2w, p1_camera_1) + cam_1.t[:, None, None, :]

    warped = backward_warp(
        torch.cat([p2_camera_2, depth_2[..., None]], dim=-1), flow_1_2)

    pix_1_in_2, p1_camera_2 = project(global_p1 + sflow_1_2, cam_2)
    pix_static, _ = project(global_p1, cam_2)
    # z of K @ cam_pts; with a standard intrinsics last row this is cam z
    depth_image_1_2 = (cam_2.K[:, None, None, 2, :] * p1_camera_2).sum(-1)
    return {
        "dflow_1_2": pix_1_in_2 - base,
        "staticflow_1_2": pix_static - base,
        "depth_image_1_2": depth_image_1_2,
        "depth_warp_1_2": warped[..., 3],
        "depth_1": depth_1,
        "depth_2": depth_2,
        "scenef_1_2": sflow_1_2,
        "global_p1": global_p1,
        "p1_camera_2": p1_camera_2,
        "warped_p2_camera_2": warped[..., :3],
    }


def depth_warp_stage(depth_1, depth_2, flow_1_2, cam_1: Camera,
                     cam_2: Camera, warp_fn=None) -> Dict[str, torch.Tensor]:
    """Unprojections, the single 4-channel warp of ``[p2_camera_2, depth_2]``
    by the observed flow, and the flow-implied scene flow. ``warp_fn(buffer,
    flow)`` defaults to the warp kernel's wrapper (its plain version on a CPU
    tensor)."""
    if warp_fn is None:
        warp_fn = backward_warp
    p1_camera_1 = unproject_camera(depth_1, cam_1)
    p2_camera_2 = unproject_camera(depth_2, cam_2)
    global_p1 = camera_to_world(p1_camera_1, cam_1)

    warp_src = torch.cat([p2_camera_2, depth_2[..., None]], dim=-1)
    warped = warp_fn(warp_src, flow_1_2)
    warped_p2_camera_2 = warped[..., :3]
    warped_global_p2 = camera_to_world(warped_p2_camera_2, cam_2)
    return {
        "global_p1": global_p1,
        "sf_by_depth": warped_global_p2 - global_p1,
        "warped_p2_camera_2": warped_p2_camera_2,
        "depth_warp_1_2": warped[..., 3],
    }


def projection_stage(depth_1, depth_2, cam_2: Camera, sflow_1_2,
                     stage: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Advect by the scene flow and reproject into camera 2, completing a
    ``depth_warp_stage`` result."""
    _, h, w = depth_1.shape
    base = pixel_coords(h, w, depth_1.dtype, depth_1.device)[None]
    global_p1 = stage["global_p1"]

    pix_1_in_2, p1_camera_2 = project(global_p1 + sflow_1_2, cam_2)
    pix_static, _ = project(global_p1, cam_2)
    depth_image_1_2 = (cam_2.K[:, None, None, 2, :] * p1_camera_2).sum(-1)
    return {
        "dflow_1_2": pix_1_in_2 - base,
        "staticflow_1_2": pix_static - base,
        "depth_image_1_2": depth_image_1_2,
        "depth_warp_1_2": stage["depth_warp_1_2"],
        "depth_1": depth_1,
        "depth_2": depth_2,
        "scenef_1_2": sflow_1_2,
        "global_p1": global_p1,
        "p1_camera_2": p1_camera_2,
        "warped_p2_camera_2": stage["warped_p2_camera_2"],
    }


def _shifts(x: torch.Tensor):
    """(up, down, centre, left, right) neighbours over the interior."""
    return (x[:, :-2, 1:-1], x[:, 2:, 1:-1], x[:, 1:-1, 1:-1],
            x[:, 1:-1, :-2], x[:, 1:-1, 2:])


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max, stride 1, padded with -inf (``nn.MaxPool2d(3, 1, 1)``); a
    max over the nine shifted maps, so tied maxima share the gradient as
    the JAX ``jnp.max`` does."""
    h, w = x.shape[1:]
    pad = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    return torch.stack([pad[:, i:i + h, j:j + w]
                        for i in range(3) for j in range(3)]).amax(0)


def rigidity_loss(global_p1: torch.Tensor, sf: torch.Tensor,
                  depth_1: torch.Tensor, s: float = 1.0):
    """Edge-aware local rigidity (reference ``calc_rigidity_loss``,
    losses/scene_flow_projection.py:156-201; the reference's model does
    not use it): for each of the four neighbours n of an interior pixel c,
    ``|‖p_n - p_c‖ - ‖sf_n - sf_c‖| * exp(-s * maxpool3(|d_n - d_c|))``.
    Returns (the sum over the neighbours ``[B,H-2,W-2]``, the terms
    ``l{u,d,l,r}`` and ``weight_{u,d,l,r}``)."""
    p_u, p_d, p_c, p_l, p_r = _shifts(global_p1)
    s_u, s_d, s_c, s_l, s_r = _shifts(sf)
    d_u, d_d, d_c, d_l, d_r = _shifts(depth_1)
    terms, total = {}, 0.0
    for name, p_n, s_n, d_n in (("u", p_u, s_u, d_u), ("d", p_d, s_d, d_d),
                                ("l", p_l, s_l, d_l), ("r", p_r, s_r, d_r)):
        l_n = (torch.linalg.vector_norm(p_n - p_c, dim=-1)
               - torch.linalg.vector_norm(s_n - s_c, dim=-1)).abs()
        w_n = torch.exp(-s * _maxpool3((d_n - d_c).abs()))
        terms["l" + name] = l_n
        terms["weight_" + name] = w_n
        total = total + w_n * l_n
    return total, terms
