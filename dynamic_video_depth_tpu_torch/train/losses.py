"""Consistency losses (counterpart of
``dynamic_video_depth_tpu/train/losses.py``; reference
models/scene_flow_motion_field.py:285-344, models/video_base.py:66-74).

Occlusion-masked sums are divided by the mask mass; a K-channel residual is
summed over its channels but normalized by the scalar mask mass, as the
reference's broadcast does.

Under data parallelism the step divides each rank's sums by the ranks'
*total* mask mass (``masked_means``) and the regularizer's sum by their
total element count (``acceleration_reg(count=...)``), so that the ranks'
losses add up to the loss of the whole batch; those denominators carry no
gradient (the masks are data and comparisons).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

_MASK_EPS = 1e-8
_MIDAS_FAR = 100.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (reference models/scene_flow_motion_field.py:
    33-67)."""

    flow_mul: float = 10.0
    disp_mul: float = 10.0
    acc_mul: float = 100.0
    sf_mag_div: float = 100.0
    use_disp: bool = False
    use_disp_ratio: bool = False
    midas: bool = False
    weight_steps: bool = False
    warm_reg: bool = False
    interp_steps: int = 5


def disp_residual(d1, d2, cfg: LossConfig) -> torch.Tensor:
    """(reference Model.disp_loss, models/scene_flow_motion_field.py:140)"""
    if cfg.use_disp:
        t1, t2 = d1.clamp(min=1e-3), d2.clamp(min=1e-3)
        return 100.0 * torch.abs(1.0 / t1 - 1.0 / t2)
    if cfg.use_disp_ratio:
        t1, t2 = d1.clamp(min=1e-3), d2.clamp(min=1e-3)
        return torch.maximum(t1, t2) / torch.minimum(t1, t2) - 1.0
    return torch.abs(d1 - d2)


def consistency_sums(pred: Dict[str, torch.Tensor], flow_gt_1_2, mask_2,
                     cfg: LossConfig, warm: bool):
    """The occlusion-masked flow, disparity and scene-flow residual sums
    (L2 flow residual during warm-up, L1 after) and the mask mass."""
    occ = mask_2[..., None]
    if cfg.midas:
        occ = occ * (pred["depth_1"][..., None] < _MIDAS_FAR).to(occ.dtype)
        occ = occ * (pred["warped_p2_camera_2"][..., 2:3]
                     < _MIDAS_FAR).to(occ.dtype)

    resid = pred["dflow_1_2"] - flow_gt_1_2
    disp = disp_residual(pred["p1_camera_2"][..., 2],
                         pred["warped_p2_camera_2"][..., 2], cfg)
    sums = (torch.sum(occ * (resid ** 2 if warm else torch.abs(resid))),
            torch.sum(occ * disp[..., None]),
            torch.sum(occ * torch.abs(pred["sf_by_dep_1_2"]
                                      - pred["sf_1_2"])))
    return sums, torch.sum(occ)


def masked_means(sums, mass: torch.Tensor, cfg: LossConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three residual sums over the mask mass, combined into the loss.
    Returns (loss, logged scalars)."""
    denom = mass + _MASK_EPS
    flow_loss_1_2, disp_loss_1_2, sf_loss = (x / denom for x in sums[:3])
    second = disp_loss_1_2 if cfg.use_disp else sf_loss
    loss = flow_loss_1_2 * cfg.flow_mul + second * cfg.disp_mul
    return loss, {
        "loss": loss,
        "flow_loss_1_2": flow_loss_1_2,
        "disp_loss_1_2": disp_loss_1_2,
        "sf_loss": sf_loss,
    }


def acceleration_reg(sf_t0, sf_t1, cfg: LossConfig,
                     count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc_mul * mean |sf_t1 - sf_t0|`` (reference _opt_reg); with
    ``count`` the sum over that element count instead of the local one."""
    diff = torch.abs(sf_t1 - sf_t0)
    if count is None:
        return cfg.acc_mul * torch.mean(diff)
    return cfg.acc_mul * (torch.sum(diff) / count)


def disparity_vali_loss(depth_pred, depth_gt) -> torch.Tensor:
    """Masked disparity MSE used for model selection (reference
    models/video_base.py:66-74)."""

    def depth2disp(d):
        valid = (d > 1e-2).to(d.dtype)
        return (1.0 / (d + (1.0 - valid) * 1e-8)) * valid

    valid_gt = (depth_gt > 1e-2).to(depth_gt.dtype)
    a = depth2disp(depth_pred) * valid_gt
    b = depth2disp(depth_gt) * valid_gt
    return torch.mean((a - b) ** 2)
