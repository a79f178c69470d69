"""Image resizing (counterpart of ``dynamic_video_depth_tpu/ops/resize.py``).

The interpolation configurations of the reference, on channel-last
``[B, H, W, C]`` tensors, through ``F.interpolate`` with its default
``antialias=False`` (the JAX package writes them as separable interpolation
matrices for the TPU's matrix unit, which have no antialias; they are not
kernels). The MiDaS nets use three:
- bilinear, align_corners=True  (the MiDaS FeatureFusionBlock upsample);
- bilinear, align_corners=False (the MiDaS output head);
- bicubic, align_corners=True   (the optional MiDaS input resize).
Preprocessing adds two:
- bicubic, align_corners=False as a downscale (stage 2's flows, 288x512 to
  the working resolution);
- bilinear, align_corners=False as a large downscale (raw frames to the
  working resolution in stage 1 and to 288x512 for RAFT in stage 2).
torch's bicubic uses a = -0.75, does not clamp the continuous source index
and clamps its taps to the border, which is ``_cubic_matrix`` of the JAX
package; its bilinear clamps the source index into the input, which is
``_linear_matrix`` (both held against them in the tests).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _interpolate(x: torch.Tensor, out_hw, mode: str,
                 align_corners: bool) -> torch.Tensor:
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode=mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def upsample2x_nchw(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """2x bilinear upsampling of ``[B, C, H, W]`` (the nets' layout)."""
    _, _, h, w = x.shape
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool) -> torch.Tensor:
    """Bilinearly resize ``[B, H, W, C]`` to ``out_hw = (H2, W2)``."""
    return _interpolate(x, out_hw, "bilinear", align_corners)


def resize_bicubic(x: torch.Tensor, out_hw,
                   align_corners: bool) -> torch.Tensor:
    """Bicubic-resize ``[B, H, W, C]`` to ``out_hw = (H2, W2)``."""
    return _interpolate(x, out_hw, "bicubic", align_corners)


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """2x bilinear upsampling of ``[B, H, W, C]``."""
    return upsample2x_nchw(x.permute(0, 3, 1, 2),
                           align_corners).permute(0, 2, 3, 1)
