"""Kernel D: the fused scene-flow projection and consistency-loss sums,
forward and backward.

Replaces ``dynamic_video_depth_tpu/ops/pallas/loss_kernel.py::
fused_projection_loss`` (forward) and ``_loss_bwd``. The CUDA source is
``csrc/projection_loss.cu``; the plain version, ``projection_loss_plain``,
is the per-pixel chain of ``_pixel_chain`` written in torch and summed,
differentiated by autograd.

Dispatch: a CPU tensor takes the plain version (the CPU oracle); a CUDA
tensor launches the kernels or raises. There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from ..camera import Camera
from . import build

LIBRARY = "dvd_projection_loss"
SOURCES = ("projection_loss.cu",)
# each product and sum rounds on its own, in the plain version's order
FLAGS = ("--fmad=false",)
REPLACES = "dynamic_video_depth_tpu/ops/pallas/loss_kernel.py:317"
EPS_PROJ = 1e-8
Z_DEGENERATE = 1e-3
CLIP_MIN = 1e-3
MIDAS_FAR = 100.0
_MIDAS, _USE_DISP, _USE_DISP_RATIO, _WARM = 1, 2, 4, 8
# launches of each kernel since the last reset
launches = {"loss_fwd": 0, "loss_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def device_type(t: torch.Tensor) -> str:
    return t.device.type


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pack_camera(cam: Camera) -> torch.Tensor:
    """The kernel's ``[B, 24]`` camera rows: ``R_c2w`` row-major (9), ``t``
    (3), ``K`` row-major (9), 3 zeros."""
    b = cam.t.shape[0]
    return torch.cat([cam.R_c2w.reshape(b, 9), cam.t.reshape(b, 3),
                      cam.K.reshape(b, 9),
                      torch.zeros((b, 3), dtype=cam.t.dtype,
                                  device=cam.t.device)], dim=-1).float()


def projection_loss_plain(gp1, w3, sf, flow, mask, depth_1, cam,
                          use_disp: bool, use_disp_ratio: bool, midas: bool,
                          warm: bool) -> torch.Tensor:
    """``[flow_sum, disp_sum, sf_sum, occ_mass]`` over the batch, each
    product and sum in the order of ``_pixel_chain``. Differentiable at
    ``gp1``, ``w3`` and ``sf``; the masks, flow and ``depth_1`` are data."""
    b, h, w, _ = gp1.shape
    c = cam.reshape(b, 1, 1, 24)
    R = [[c[..., 3 * i + j] for j in range(3)] for i in range(3)]
    t = [c[..., 9 + i] for i in range(3)]
    K = [[c[..., 12 + 3 * i + j] for j in range(3)] for i in range(3)]
    g = [gp1[..., i] for i in range(3)]
    wv = [w3[..., i] for i in range(3)]
    s = [sf[..., i] for i in range(3)]
    occ = mask
    if midas:
        occ = occ * (depth_1 < MIDAS_FAR).to(occ.dtype)
        occ = occ * (wv[2] < MIDAS_FAR).to(occ.dtype)
    wg = [R[i][0] * wv[0] + R[i][1] * wv[1] + R[i][2] * wv[2] + t[i]
          for i in range(3)]
    q = [wg[i] - g[i] - s[i] for i in range(3)]
    rel = [g[i] + s[i] - t[i] for i in range(3)]
    p1c2 = [R[0][i] * rel[0] + R[1][i] * rel[1] + R[2][i] * rel[2]
            for i in range(3)]
    img = [K[i][0] * p1c2[0] + K[i][1] * p1c2[1] + K[i][2] * p1c2[2]
           for i in range(3)]
    z = img[2]
    alive = z >= Z_DEGENERATE
    live = alive.to(z.dtype)
    # the safe denominator keeps a dead pixel's gradient 0 (not 0 * inf)
    inv_z = torch.where(alive, 1.0 / torch.where(alive, z + EPS_PROJ, 1.0),
                        0.0)
    xs = torch.arange(w, dtype=gp1.dtype, device=gp1.device)
    ys = torch.arange(h, dtype=gp1.dtype, device=gp1.device)[:, None]
    rx = (img[0] * inv_z - xs) * live - flow[..., 0]
    ry = (img[1] * inv_z - ys) * live - flow[..., 1]
    flow_r = rx * rx + ry * ry if warm else torch.abs(rx) + torch.abs(ry)

    c1, c2 = p1c2[2], wv[2]
    if use_disp or use_disp_ratio:
        # max(c, 1e-3) whose gradient passes only where c > 1e-3
        t1 = torch.where(c1 > CLIP_MIN, c1, CLIP_MIN)
        t2 = torch.where(c2 > CLIP_MIN, c2, CLIP_MIN)
        if use_disp:
            disp_r = 100.0 * torch.abs(1.0 / t1 - 1.0 / t2)
        else:
            one_is_hi = t1 >= t2
            disp_r = (torch.where(one_is_hi, t1, t2)
                      / torch.where(one_is_hi, t2, t1) - 1.0)
    else:
        disp_r = torch.abs(c1 - c2)
    sf_r = torch.abs(q[0]) + torch.abs(q[1]) + torch.abs(q[2])
    return torch.stack([torch.sum(occ * flow_r), torch.sum(occ * disp_r),
                        torch.sum(occ * sf_r), torch.sum(occ)])


def _lib():
    lib = build.load_library(LIBRARY, SOURCES, FLAGS)
    if not getattr(lib, "_dvd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dvd_loss_partials.argtypes = [i, i]
        lib.dvd_loss_partials.restype = i
        lib.dvd_loss_fwd.argtypes = [p] * 7 + [i] * 4 + [p, p, p]
        lib.dvd_loss_fwd.restype = i
        lib.dvd_loss_bwd.argtypes = [p] * 7 + [i] * 4 + [p, p, p, p, p]
        lib.dvd_loss_bwd.restype = i
        lib._dvd_typed = True
    return lib


def _check(tensors) -> tuple:
    """Shapes, device and type of ``(gp1, w3, sf, flow, mask, depth_1,
    cam)``; returns ``(B, H, W)``."""
    gp1 = tensors[0]
    if gp1.dim() != 4 or gp1.shape[-1] != 3:
        raise ValueError(f"loss kernel: global_p1 {tuple(gp1.shape)} is not "
                         "[B,H,W,3]")
    b, h, w, _ = gp1.shape
    shapes = ((b, h, w, 3), (b, h, w, 3), (b, h, w, 3), (b, h, w, 2),
              (b, h, w), (b, h, w), (b, 24))
    names = ("global_p1", "warped_p2c2", "sf", "flow", "mask", "depth_1",
             "cam")
    for name, t, shape in zip(names, tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"loss kernel: {name} {tuple(t.shape)} is not "
                             f"{list(shape)}")
        if device_type(t) != "cuda":
            raise RuntimeError(f"loss kernel: {name} is on {t.device}, not a "
                               "CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"loss kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != gp1.device:
            raise RuntimeError("loss kernel: tensors on different devices")
    return b, h, w


def flag_bits(use_disp, use_disp_ratio, midas, warm) -> int:
    """The kernels' configuration word."""
    return ((_MIDAS if midas else 0) | (_USE_DISP if use_disp else 0)
            | (_USE_DISP_RATIO if use_disp_ratio else 0)
            | (_WARM if warm else 0))


def loss_forward_cuda(tensors, flags: int) -> torch.Tensor:
    """Launch the forward and its fixed-order reduce; returns ``[4]``."""
    b, h, w = _check(tensors)
    tensors = [t.contiguous() for t in tensors]
    lib = _lib()
    dev = tensors[0].device
    part = torch.empty((lib.dvd_loss_partials(b, h * w), 4), device=dev,
                       dtype=torch.float32)
    out = torch.empty(4, device=dev, dtype=torch.float32)
    rc = lib.dvd_loss_fwd(*(t.data_ptr() for t in tensors), b, h, w, flags,
                          part.data_ptr(), out.data_ptr(), stream_handle(dev))
    build.check(rc, "dvd_loss_fwd")
    launches["loss_fwd"] += 1
    return out


def loss_backward_cuda(tensors, flags: int, cot: torch.Tensor):
    """Launch the backward; returns the gradients at ``(gp1, w3, sf)``."""
    b, h, w = _check(tensors)
    tensors = [t.contiguous() for t in tensors]
    dev = tensors[0].device
    if cot.shape != (4,) or cot.dtype != torch.float32 or cot.device != dev:
        raise ValueError(f"loss kernel: cotangent {tuple(cot.shape)} "
                         f"{cot.dtype} is not [4] float32 on {dev}")
    cot = cot.contiguous()
    grads = [torch.empty((b, h, w, 3), device=dev, dtype=torch.float32)
             for _ in range(3)]
    rc = _lib().dvd_loss_bwd(*(t.data_ptr() for t in tensors), b, h, w,
                             flags, cot.data_ptr(),
                             *(g.data_ptr() for g in grads),
                             stream_handle(dev))
    build.check(rc, "dvd_loss_bwd")
    launches["loss_bwd"] += 1
    return grads


class _LossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gp1, w3, sf, flow, mask, depth_1, cam, flags):
        tensors = (gp1, w3, sf, flow, mask, depth_1, cam)
        ctx.save_for_backward(*tensors)
        ctx.flags = flags
        return loss_forward_cuda(tensors, flags)

    @staticmethod
    def backward(ctx, cot):
        dgp1, dw3, dsf = loss_backward_cuda(ctx.saved_tensors, ctx.flags,
                                            cot)
        return dgp1, dw3, dsf, None, None, None, None, None


def projection_loss(gp1, w3, sf, flow, mask, depth_1, cam,
                    use_disp: bool = False, use_disp_ratio: bool = False,
                    midas: bool = False, warm: bool = False) -> torch.Tensor:
    """``[flow_sum, disp_sum, sf_sum, occ_mass]`` (float32 ``[4]``) of the
    projection of ``gp1 + sf`` into the camera ``cam`` (``pack_camera``);
    the caller divides by ``occ_mass + 1e-8`` for the masked means.
    Differentiable at ``gp1``, ``w3`` and ``sf`` only."""
    data = (flow.detach(), mask.detach(), depth_1.detach(), cam.detach())
    if device_type(gp1) == "cpu":
        return projection_loss_plain(gp1, w3, sf, *data, use_disp,
                                     use_disp_ratio, midas, warm)
    return _LossFn.apply(gp1, w3, sf, *data,
                         flag_bits(use_disp, use_disp_ratio, midas, warm))
