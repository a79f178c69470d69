"""The scene-flow motion-field model around the train step (counterpart of
``dynamic_video_depth_tpu/train/scene_flow_motion_field.py``; reference
models/scene_flow_motion_field.py).

``Model`` builds a ``SceneFlowMotionFieldStep`` from the options, loads the
pretrained depth net (MiDaS with ``--midas``, else the hourglass; the test
net ``tiny`` has none) from ``MIDAS_PRETRAIN_PATH`` /
``DEPTH_PRETRAIN_PATH`` (the environment variables ``DVD_MIDAS_CKPT`` /
``DVD_HOURGLASS_CKPT``) when the file is there, and turns the step's
tensors into the numpy dicts that visualization and the test dumps write.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..runtime import weights
from .losses import LossConfig
from .step import SceneFlowMotionFieldStep, TrainStepConfig, effective_depth_net


def step_config(opt) -> TrainStepConfig:
    """The step's configuration; the net and the loss's MiDaS masks both
    follow ``effective_depth_net``."""
    net = effective_depth_net(opt.depth_net, opt.midas)
    return TrainStepConfig(
        lr=opt.lr, scene_lr_mul=opt.scene_lr_mul,
        adam_beta1=opt.adam_beta1, adam_beta2=opt.adam_beta2,
        midas=net == "midas", depth_net=net,
        time_dependent=opt.time_dependent,
        n_freq_xyz=opt.n_freq_xyz, n_freq_t=opt.n_freq_t,
        init_type=opt.init_type,
        loss=LossConfig(
            flow_mul=opt.flow_mul, disp_mul=opt.disp_mul,
            acc_mul=opt.acc_mul, sf_mag_div=opt.sf_mag_div,
            use_disp=opt.use_disp, use_disp_ratio=opt.use_disp_ratio,
            midas=net == "midas", weight_steps=opt.weight_steps,
            warm_reg=opt.warm_reg, interp_steps=opt.interp_steps),
        use_motion_seg=opt.use_motion_seg,
        use_pallas_sf_chain=opt.use_pallas_sf_chain,
        use_pallas_loss=opt.use_pallas_loss,
    )


def numpy_dict(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


class Model:
    """The step, its pretrained depth weights and its output packing."""

    def __init__(self, opt, device="cuda", seed: int = 0,
                 pretrained: bool = True):
        self.opt = opt
        self.cfg = step_config(opt)
        self.step = SceneFlowMotionFieldStep(self.cfg, device=device,
                                             seed=seed)
        self.used_pretrained = pretrained and self.load_pretrained()

    def load_pretrained(self) -> bool:
        """Load the pretrained depth checkpoint when it exists (reference:
        models/scene_flow_motion_field.py:94-121); returns whether it did."""
        if self.cfg.depth_net == "tiny":
            return False
        midas = self.cfg.midas
        path = (weights.MIDAS_PRETRAIN_PATH if midas
                else weights.DEPTH_PRETRAIN_PATH)
        if not os.path.isfile(path):
            print(f"Warning: pretrained depth checkpoint {path} not found; "
                  "using random init. Fetch the official artifacts with "
                  "scripts/download_data_and_depth_ckpt.sh or point "
                  "DVD_MIDAS_CKPT / DVD_HOURGLASS_CKPT at them.", flush=True)
            return False
        weights.load_pretrained_depth(self.step.net_depth, path, midas)
        return True

    def count_params(self) -> Dict[str, int]:
        """(reference: models/netinterface.py:433-440)."""
        return {
            "net_depth": sum(p.numel() for p in
                             self.step.net_depth.parameters()),
            "net_sceneflow": sum(p.numel() for p in
                                 self.step.net_sf.parameters()),
        }

    def vis_on_batch(self, batch: Dict[str, torch.Tensor],
                     steps: int) -> Dict[str, np.ndarray]:
        """The prediction dict of a training pair, for visualization."""
        return numpy_dict(self.step.forward_vis(batch, steps))

    def test_on_batch(self, batch_idx: int,
                      batch: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """One frame's ``depth`` and one-step ``sf_1_2``."""
        return numpy_dict(self.step.predict(batch))

    @staticmethod
    def pack_output(pred: Dict[str, np.ndarray],
                    batch: Dict) -> Dict[str, np.ndarray]:
        """The prediction with the inputs the dumps carry beside it
        (reference: pack_output, models/video_base.py:105-126); ``batch``
        is the host (numpy) batch."""
        out = dict(pred)
        if "img" in batch:
            out["img_1"] = np.asarray(batch["img"])
            out["depth_nn"] = np.asarray(batch["depth_pred"])
            out["depth_gt"] = np.asarray(batch["depth_mvs"])
        else:
            out["img_1"] = np.asarray(batch["img_1"])
            out["img_2"] = np.asarray(batch["img_2"])
            out["flow_1_2"] = np.asarray(batch["flow_1_2"])
            out["flow_2_1"] = np.asarray(batch["flow_2_1"])
            out["depth_nn_1"] = np.asarray(batch["depth_pred_1"])
        return out
