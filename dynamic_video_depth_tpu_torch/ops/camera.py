"""Camera tuple and conversion from and to the reference's packed pose
format (counterpart of ``dynamic_video_depth_tpu/ops/camera.py``).

The packed datafiles store row-vector matrices (``R = R_c2w.T``,
``K = K.T``, ``K_inv = inv(K).T``); internally cameras are plain
column-vector matrices ``R_c2w [B,3,3]``, ``t [B,3]``, ``K``/``K_inv``
``[B,3,3]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """A camera-to-world pose plus intrinsics, batched ``[B, ...]``."""

    R_c2w: torch.Tensor  # [B, 3, 3]
    t: torch.Tensor      # [B, 3]
    K: torch.Tensor      # [B, 3, 3]
    K_inv: torch.Tensor  # [B, 3, 3]


def packed_from_camera(cam: Camera):
    """Inverse of ``camera_from_packed``, for writing reference-format
    files: ``(R, R_T, t, K, K_inv)``, the matrices ``[B,1,1,3,3]``
    (``R_T`` is ``R_c2w`` itself, the others transposed) and ``t``
    ``[B,1,1,1,3]``."""
    b = cam.R_c2w.shape[0]
    return (cam.R_c2w.transpose(-1, -2).reshape(b, 1, 1, 3, 3),
            cam.R_c2w.reshape(b, 1, 1, 3, 3),
            cam.t.reshape(b, 1, 1, 1, 3),
            cam.K.transpose(-1, -2).reshape(b, 1, 1, 3, 3),
            cam.K_inv.transpose(-1, -2).reshape(b, 1, 1, 3, 3))


def _as_b33(m: torch.Tensor) -> torch.Tensor:
    if m.dim() == 2:
        m = m[None]
    return m.reshape(m.shape[0], 3, 3)


def camera_from_packed(R, t, K, K_inv) -> Camera:
    """Build a :class:`Camera` from the packed (transposed) format:
    ``R``/``K``/``K_inv`` as ``[B,1,1,3,3]`` (or ``[B,1,3,3]``/``[B,3,3]``),
    ``t`` as ``[B,1,1,1,3]`` or any shape reducible to ``[B,3]``."""
    R, t, K, K_inv = (torch.as_tensor(x) for x in (R, t, K, K_inv))
    t = t.reshape(t.shape[0], -1)[:, :3] if t.dim() > 2 else t.reshape(-1, 3)
    return Camera(
        R_c2w=_as_b33(R).transpose(-1, -2),
        t=t,
        K=_as_b33(K).transpose(-1, -2),
        K_inv=_as_b33(K_inv).transpose(-1, -2),
    )
