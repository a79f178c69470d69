"""The per-video optimization step (counterpart of
``dynamic_video_depth_tpu/train/step.py``; reference
models/scene_flow_motion_field.py:152-344).

One step: a batched depth forward over both frames, the backward warp
(kernel A), Euler integration of the scene-flow field across the frame gap,
projection into camera 2 and the masked losses plus the acceleration
regularizer, one backward pass, then one Adam update over two parameter
groups (depth net at ``lr``, scene-flow net at ``lr * scene_lr_mul``).
During warm-up the depth net runs without gradient, so its group is not
stepped.

Two paths, each chosen by an ``auto|on|off`` mode (the JAX flags of the
same names). ``auto`` turns both on for a CUDA device and off on the CPU;
``on`` on the CPU runs the kernels' plain versions.
- ``use_pallas_sf_chain``: a chain of two or more field evaluations runs
  through kernel C (kernel B's forward per evaluation, one backward over
  all of them); off, kernel B runs forward and backward per evaluation.
- ``use_pallas_loss``: everything between the depth net and the scalar
  losses runs fused: the 3-channel warp of the camera-2 points (kernel A),
  the chain, then the projection-loss sums (kernel D); off, the plain
  geometry and losses with the 4-channel warp.

The gap (``steps``) is a plain Python int and ``warm`` a plain bool: PyTorch
runs eagerly, so nothing is specialized or bucketed per value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models import (HourglassModelEmbed, MidasNet, SceneFlowFieldNet,
                      TinyDepthNet)
from ..ops import (Camera, backward_warp, camera_to_world, depth_warp_stage,
                   projection_stage, unproject, unproject_camera)
from ..ops.cuda.loss_kernel import pack_camera, projection_loss
from ..runtime.device import resolve_device
from .losses import (_MASK_EPS, LossConfig, acceleration_reg,
                     consistency_losses, disparity_vali_loss)

DEPTH_NETS = ("hourglass", "midas", "tiny")
FUSED_MODES = ("auto", "on", "off")


def effective_depth_net(depth_net: str, midas: bool) -> str:
    """The depth net a configuration runs: an explicit ``depth_net`` wins,
    ``''`` defers to the ``midas`` flag (the JAX CLI's rule,
    train/scene_flow_motion_field.py:136-137)."""
    if depth_net:
        return depth_net
    return "midas" if midas else "hourglass"


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Net and optimization hyperparameters (reference flags
    options/options_train.py:84-90, models/scene_flow_motion_field.py:33-67)."""

    lr: float = 1e-6
    scene_lr_mul: float = 1.0
    adam_beta1: float = 0.5
    adam_beta2: float = 0.9
    midas: bool = False
    depth_net: str = ""  # '' defers to midas; 'tiny' for tests
    midas_resize: Optional[Tuple[int, int]] = None
    time_dependent: bool = True
    n_freq_xyz: int = 16
    n_freq_t: int = 16
    net_width: int = 256
    n_layers: int = 4
    init_type: str = "kaiming"
    init_param: float = 0.01
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    use_motion_seg: bool = False
    use_pallas_sf_chain: str = "auto"
    use_pallas_loss: str = "auto"


def batch_cameras(batch: Dict[str, torch.Tensor]):
    cam_1 = Camera(batch["R_1"], batch["t_1"], batch["K"], batch["K_inv"])
    cam_2 = Camera(batch["R_2"], batch["t_2"], batch["K"], batch["K_inv"])
    return cam_1, cam_2


class SceneFlowMotionFieldStep:
    """Owns both nets and their optimizer and runs train/vali steps on
    batches of tensors already on ``device``."""

    def __init__(self, cfg: TrainStepConfig, device="cuda", seed: int = 0):
        net = effective_depth_net(cfg.depth_net, cfg.midas)
        if net not in DEPTH_NETS:
            raise ValueError(f"depth_net={cfg.depth_net!r} not in "
                             f"{DEPTH_NETS}")
        for name in ("use_pallas_sf_chain", "use_pallas_loss"):
            if getattr(cfg, name) not in FUSED_MODES:
                raise ValueError(f"{name}={getattr(cfg, name)!r} not in "
                                 f"{FUSED_MODES}")
        # Float32 everywhere, as the JAX package's default float32 compute:
        # no TF32 in cuDNN convolutions or in matrix products.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chain_fused = self._fused(cfg.use_pallas_sf_chain)
        self.loss_fused = self._fused(cfg.use_pallas_loss)
        gen = torch.Generator().manual_seed(seed)
        if net == "tiny":
            net_depth = TinyDepthNet(generator=gen)
        elif net == "midas":
            net_depth = MidasNet(non_negative=True, normalize_input=True,
                                 resize=cfg.midas_resize, generator=gen)
        else:
            net_depth = HourglassModelEmbed(generator=gen)
        self.net_depth = net_depth.to(self.device).eval()
        self.net_sf = SceneFlowFieldNet(
            time_dependent=cfg.time_dependent, n_freq_xyz=cfg.n_freq_xyz,
            n_freq_t=cfg.n_freq_t, net_width=cfg.net_width,
            n_layers=cfg.n_layers, init_type=cfg.init_type,
            init_param=cfg.init_param, generator=gen,
        ).to(self.device)
        self.optimizer = self.make_optimizer()

    def _fused(self, mode: str) -> bool:
        return mode == "on" or (mode == "auto"
                                and self.device.type == "cuda")

    def make_optimizer(self) -> torch.optim.Adam:
        """One Adam, two groups: the depth net (group 0) and the scene-flow
        net (group 1). A group whose gradients are None is not stepped."""
        cfg = self.cfg
        kw = dict(betas=(cfg.adam_beta1, cfg.adam_beta2), eps=1e-8)
        return torch.optim.Adam([
            {"params": list(self.net_depth.parameters()), "lr": cfg.lr},
            {"params": list(self.net_sf.parameters()),
             "lr": cfg.lr * cfg.scene_lr_mul},
        ], **kw)

    # -------------------------------------------------------------- forwards

    def _apply_sf(self, pts, ts):
        """One field query, divided by ``sf_mag_div``."""
        sf = self.net_sf(pts, ts if self.cfg.time_dependent else None)
        return sf / self.cfg.loss.sf_mag_div

    def _sf_multi_step(self, pts, ts, time_step, steps: int,
                       want_second: bool = False):
        """Euler integration across the gap (reference
        forward_sf_net_multi_step). Returns the accumulated flow and the
        first two evaluations, which the acceleration regularizer reuses: it
        queries the field at (p1, t1) and (p1 + sf0, t1 + dt), exactly
        evaluations 1 and 2. With ``want_second`` at ``steps == 1`` a
        second, phantom evaluation advects without accumulating. Two or
        more evaluations run as one chain when the chain path is on."""
        n_evals = max(2, steps) if want_second else steps
        if n_evals >= 2 and self.chain_fused:
            return self._sf_chain(pts, ts, time_step, steps, n_evals)
        sf_acc = torch.zeros_like(pts)
        evals = []
        for k in range(n_evals):
            sf = self._apply_sf(pts, ts)
            if len(evals) < 2:
                evals.append(sf)
            if k < steps:
                sf_acc = sf_acc + sf
            if k + 1 < n_evals:
                pts = pts + sf
                ts = ts + time_step
        first = evals[0] if evals else None
        second = evals[1] if len(evals) > 1 else None
        return sf_acc, first, second

    def _sf_chain(self, pts, ts, time_step, steps: int, n_evals: int):
        """The chain branch (JAX step.py:356-390) on flat points."""
        b, h, w, _ = pts.shape
        n = b * h * w
        if self.cfg.time_dependent:
            ts_flat = ts.reshape(n, 1)
            dt_flat = torch.broadcast_to(time_step, ts.shape).reshape(n, 1)
        else:
            ts_flat = dt_flat = torch.zeros((n, 1), dtype=pts.dtype,
                                            device=pts.device)
        outs = self.net_sf.chain(pts.reshape(n, 3), ts_flat, dt_flat, steps,
                                 n_evals, self.cfg.loss.sf_mag_div)
        return tuple(o.reshape(b, h, w, 3) for o in outs)

    def _depths(self, batch, depth_grad: bool):
        """One depth forward over both frames: ``(depth_1, depth_2)``."""
        b = batch["img_1"].shape[0]
        with torch.set_grad_enabled(depth_grad):
            depths = self.net_depth(
                torch.cat([batch["img_1"], batch["img_2"]], dim=0))
        return depths[:b], depths[b:]

    def _forward(self, batch, steps: int, depth_grad: bool,
                 want_second: bool = False):
        cam_1, cam_2 = batch_cameras(batch)
        depth_1, depth_2 = self._depths(batch, depth_grad)
        stage = depth_warp_stage(depth_1, depth_2, batch["flow_1_2"], cam_1,
                                 cam_2)
        global_p1 = stage["global_p1"]
        sf_1_2, first_sf, second_sf = self._sf_multi_step(
            global_p1, batch["time_stamp_1"], batch["time_step"], steps,
            want_second=want_second)
        if self.cfg.use_motion_seg:
            sf_1_2 = sf_1_2 * batch["motion_seg_1"]
        pred = projection_stage(depth_1, depth_2, cam_2, sf_1_2, stage)
        pred["sf_1_2"] = sf_1_2
        pred["sf_by_dep_1_2"] = stage["sf_by_depth"]
        return pred, first_sf, second_sf

    def _fused_loss_forward(self, batch, steps: int, warm: bool,
                            want_second: bool = False):
        """The losses with everything between the depth net and the scalars
        fused (JAX step.py:496-548): the 3-channel warp of the camera-2
        points (the 4th, warped-depth channel only serves visualization),
        the chain, then kernel D's four sums. ``depth_1`` enters only the
        MiDaS mask, without gradient."""
        cfg = self.cfg.loss
        cam_1, cam_2 = batch_cameras(batch)
        depth_1, depth_2 = self._depths(batch, depth_grad=not warm)
        flow = batch["flow_1_2"]
        warped3 = backward_warp(unproject_camera(depth_2, cam_2), flow)
        global_p1 = camera_to_world(unproject_camera(depth_1, cam_1), cam_1)
        sf_1_2, first_sf, second_sf = self._sf_multi_step(
            global_p1, batch["time_stamp_1"], batch["time_step"], steps,
            want_second=want_second)
        if self.cfg.use_motion_seg:
            sf_1_2 = sf_1_2 * batch["motion_seg_1"]
        sums = projection_loss(
            global_p1, warped3, sf_1_2, flow, batch["mask_2"],
            depth_1.detach(), pack_camera(cam_2), cfg.use_disp,
            cfg.use_disp_ratio, cfg.midas, warm)
        denom = sums[3] + _MASK_EPS
        flow_loss = sums[0] / denom
        disp_loss = sums[1] / denom
        sf_loss = sums[2] / denom
        second = disp_loss if cfg.use_disp else sf_loss
        main = flow_loss * cfg.flow_mul + second * cfg.disp_mul
        logs = {"loss": main, "flow_loss_1_2": flow_loss,
                "disp_loss_1_2": disp_loss, "sf_loss": sf_loss}
        return main, logs, first_sf, second_sf

    def loss_and_logs(self, batch, steps: int, warm: bool):
        """(total loss, logs). The depth net takes gradients only outside
        warm-up."""
        cfg = self.cfg.loss
        use_reg = (cfg.interp_steps > 0 and (not warm or cfg.warm_reg)
                   and cfg.acc_mul > 0)
        if self.loss_fused:
            main, logs, first_sf, second_sf = self._fused_loss_forward(
                batch, steps, warm, want_second=use_reg)
        else:
            pred, first_sf, second_sf = self._forward(
                batch, steps, depth_grad=not warm, want_second=use_reg)
            main, logs = consistency_losses(pred, batch["flow_1_2"],
                                            batch["mask_2"], cfg, warm)
        total = main * steps if cfg.weight_steps else main
        if use_reg:
            reg = acceleration_reg(first_sf, second_sf, cfg)
            total = total + reg
            logs["acc_reg"] = reg
        else:
            logs["acc_reg"] = torch.zeros((), device=main.device)
        return total, logs

    def train_step(self, batch: Dict[str, torch.Tensor], steps: int,
                   warm: bool) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the logs as detached scalars on
        the device (the caller decides when to fetch them)."""
        self.optimizer.zero_grad(set_to_none=True)
        total, logs = self.loss_and_logs(batch, int(steps), bool(warm))
        total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in logs.items()}

    # ------------------------------------------------------ vali/test steps

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """Single-frame inference: depth and the one-step scene flow."""
        depth = self.net_depth(batch["img"])
        cam_1 = Camera(batch["R_1"], batch["t_1"], batch["K"], batch["K_inv"])
        sf_1_2, _, _ = self._sf_multi_step(
            unproject(depth, cam_1), batch["time_stamp_1"],
            batch["time_step"], steps=1)
        return {"depth": depth, "sf_1_2": sf_1_2}

    @torch.no_grad()
    def vali_step(self, batch: Dict[str, torch.Tensor]):
        pred = self.predict(batch)
        return pred, {"loss": disparity_vali_loss(pred["depth"],
                                                  batch["depth_mvs"])}
