"""The per-video optimization step (counterpart of
``dynamic_video_depth_tpu/train/step.py``; reference
models/scene_flow_motion_field.py:152-344).

One step: a batched depth forward over both frames, the backward warp
(kernel A), Euler integration of the scene-flow field across the frame gap,
projection into camera 2 and the masked losses plus the acceleration
regularizer, one backward pass, then an update by two optimizers, as the
reference keeps them: the depth net's at ``lr`` and the scene-flow net's at
``lr * scene_lr_mul``, both Adam or both SGD (``optim``). During warm-up
the depth net runs without gradient, so its optimizer is not stepped and
keeps no state.

The depth net computes in ``compute_dtype``: in bfloat16 its input and
every floating parameter and buffer are cast for the forward (the
gradients reach the float32 parameters through the casts) and its output
is cast back to float32 before anything else reads it, as the JAX
``_apply_depth`` does; with ``remat_depth`` that forward is recomputed in
the backward pass (``torch.utils.checkpoint``). The geometry, the
scene-flow net, the optimizers and the four kernels stay float32.
``use_cnn`` replaces the scene-flow MLP by ``FCNUnet`` on ``[pts, t]``;
it takes neither kernel B nor the chain. ``log_grad_stats`` adds both
nets' global gradient norms and largest absolute gradients to the logs.

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
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models import (FCNUnet, HourglassModelEmbed, MidasNet,
                      SceneFlowFieldNet, TinyDepthNet)
from ..ops import (Camera, backward_warp, camera_to_world, depth_warp_stage,
                   projection_stage, unproject, unproject_camera)
from ..ops.cuda.loss_kernel import pack_camera, projection_loss
from ..runtime.device import resolve_device
from .losses import (LossConfig, acceleration_reg, consistency_sums,
                     disparity_vali_loss, masked_means)

DEPTH_NETS = ("hourglass", "midas", "tiny")
FUSED_MODES = ("auto", "on", "off")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OPTIMS = ("adam", "sgd")
# sums a tensor over the ranks that split one batch (parallel/multi_video.py)
Reduce = Callable[[torch.Tensor], torch.Tensor]


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

    optim: str = "adam"
    lr: float = 1e-6
    scene_lr_mul: float = 1.0
    adam_beta1: float = 0.5
    adam_beta2: float = 0.9
    sgd_momentum: float = 0.9
    sgd_dampening: float = 0.0
    wdecay: float = 0.0
    midas: bool = False
    depth_net: str = ""  # '' defers to midas; 'tiny' for tests
    use_cnn: bool = False
    use_embedding: bool = False
    n_down: int = 3
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
    # the depth net's compute: 'float32' or 'bfloat16' (params stay f32)
    compute_dtype: str = "float32"
    remat_depth: bool = False
    log_grad_stats: bool = False
    use_pallas_sf_chain: str = "auto"
    use_pallas_loss: str = "auto"


def batch_cameras(batch: Dict[str, torch.Tensor]):
    cam_1 = Camera(batch["R_1"], batch["t_1"], batch["K"], batch["K_inv"])
    cam_2 = Camera(batch["R_2"], batch["t_2"], batch["K"], batch["K_inv"])
    return cam_1, cam_2


class SceneFlowMotionFieldStep:
    """Owns both nets and their optimizers and runs train/vali steps on
    batches of tensors already on ``device``."""

    def __init__(self, cfg: TrainStepConfig, device="cuda", seed: int = 0):
        net = effective_depth_net(cfg.depth_net, cfg.midas)
        if net not in DEPTH_NETS:
            raise ValueError(f"depth_net={cfg.depth_net!r} not in "
                             f"{DEPTH_NETS}")
        for name, allowed in (("use_pallas_sf_chain", FUSED_MODES),
                              ("use_pallas_loss", FUSED_MODES),
                              ("compute_dtype", tuple(COMPUTE_DTYPES)),
                              ("optim", OPTIMS)):
            if getattr(cfg, name) not in allowed:
                raise ValueError(f"{name}={getattr(cfg, name)!r} not in "
                                 f"{allowed}")
        # No TF32 in cuDNN convolutions or in matrix products: float32
        # compute is float32, as in the JAX package (bfloat16 convolutions
        # do not use the switch).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # the chain follows the embedded MLP, which a CNN field does not
        # have (JAX step.py _sf_use_pallas, _sf_chain_on)
        self.chain_fused = (not cfg.use_cnn
                            and self._fused(cfg.use_pallas_sf_chain))
        self.loss_fused = self._fused(cfg.use_pallas_loss)
        gen = torch.Generator().manual_seed(seed)
        if net == "tiny":
            net_depth = TinyDepthNet(generator=gen)
        elif net == "midas":
            net_depth = MidasNet(non_negative=True, normalize_input=True,
                                 resize=cfg.midas_resize, generator=gen)
        else:
            net_depth = HourglassModelEmbed(use_embedding=cfg.use_embedding,
                                            generator=gen)
        self.net_depth = net_depth.to(self.device).eval()
        if cfg.use_cnn:
            net_sf = FCNUnet(
                4 if cfg.time_dependent else 3, n_down=cfg.n_down, feat=32,
                block_type="double_conv", out_channel=3, norm="none",
                activation="lrelu", pad_type="reflect", generator=gen)
        else:
            net_sf = SceneFlowFieldNet(
                time_dependent=cfg.time_dependent, n_freq_xyz=cfg.n_freq_xyz,
                n_freq_t=cfg.n_freq_t, net_width=cfg.net_width,
                n_layers=cfg.n_layers, init_type=cfg.init_type,
                init_param=cfg.init_param, generator=gen)
        self.net_sf = net_sf.to(self.device)
        self.opt_depth, self.opt_sf = self.make_optimizers()

    def _fused(self, mode: str) -> bool:
        return mode == "on" or (mode == "auto"
                                and self.device.type == "cuda")

    def make_optimizers(self) -> Tuple[torch.optim.Optimizer,
                                       torch.optim.Optimizer]:
        """The depth net's optimizer and the scene-flow net's (reference
        models/scene_flow_motion_field.py:112-115, models/netinterface.py:
        125-135): Adam, or SGD with momentum, dampening and weight decay,
        whose semantics the JAX ``make_tx`` chain copies. Parameters whose
        gradients are None are not stepped."""
        cfg = self.cfg
        if cfg.optim == "sgd":
            def make(params, lr):
                return torch.optim.SGD(params, lr=lr,
                                       momentum=cfg.sgd_momentum,
                                       dampening=cfg.sgd_dampening,
                                       weight_decay=cfg.wdecay)
        else:
            def make(params, lr):
                return torch.optim.Adam(
                    params, lr=lr, betas=(cfg.adam_beta1, cfg.adam_beta2),
                    eps=1e-8)
        return (make(self.net_depth.parameters(), cfg.lr),
                make(self.net_sf.parameters(), cfg.lr * cfg.scene_lr_mul))

    @property
    def optimizers(self) -> Tuple[torch.optim.Optimizer,
                                  torch.optim.Optimizer]:
        """(depth, scene flow): the order of a checkpoint's ``optimizers``."""
        return self.opt_depth, self.opt_sf

    # -------------------------------------------------------------- forwards

    def _apply_depth(self, img: torch.Tensor) -> torch.Tensor:
        """The depth net on ``img`` in the compute dtype, float32 out (JAX
        step.py:270-283); rematerialized in the backward pass with
        ``remat_depth`` when gradients are being taken."""
        if self.cfg.remat_depth and torch.is_grad_enabled():
            return checkpoint(self._depth_fn, img, use_reentrant=False)
        return self._depth_fn(img)

    def _depth_fn(self, img: torch.Tensor) -> torch.Tensor:
        dtype, net = self.compute_dtype, self.net_depth
        if dtype == torch.float32:
            return net(img)
        tensors = dict(net.named_parameters())
        tensors.update(net.named_buffers())
        cast = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in tensors.items()}
        return functional_call(net, cast, (img.to(dtype),)).float()

    def _apply_sf(self, pts, ts):
        """One field query, divided by ``sf_mag_div``; the CNN field reads
        ``[pts, t]`` (JAX step.py:297-303)."""
        td = self.cfg.time_dependent
        if self.cfg.use_cnn:
            sf = self.net_sf(torch.cat([pts, ts], dim=-1) if td else pts)
        else:
            sf = self.net_sf(pts, ts if td else None)
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
            depths = self._apply_depth(
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

    def _fused_loss_sums(self, batch, steps: int, warm: bool,
                         want_second: bool = False):
        """Kernel D's four sums with everything between the depth net and
        them fused (JAX step.py:496-548): the 3-channel warp of the
        camera-2 points (the 4th, warped-depth channel only serves
        visualization), the chain, then the projection loss. ``depth_1``
        enters only the MiDaS mask, without gradient."""
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
        return sums, first_sf, second_sf

    def loss_and_logs(self, batch, steps: int, warm: bool,
                      reduce: Optional[Reduce] = None):
        """(total loss, logs). The depth net takes gradients only outside
        warm-up. With ``reduce`` (a sum over the ranks that split one
        batch) the mask mass and the regularizer's element count are the
        ranks' totals, in one reduction, so each rank's loss is its share
        of the whole batch's."""
        cfg = self.cfg.loss
        use_reg = (cfg.interp_steps > 0 and (not warm or cfg.warm_reg)
                   and cfg.acc_mul > 0)
        if self.loss_fused:
            sums, first_sf, second_sf = self._fused_loss_sums(
                batch, steps, warm, want_second=use_reg)
            mass = sums[3]
        else:
            pred, first_sf, second_sf = self._forward(
                batch, steps, depth_grad=not warm, want_second=use_reg)
            sums, mass = consistency_sums(pred, batch["flow_1_2"],
                                          batch["mask_2"], cfg, warm)
        count = None
        if reduce is not None:
            n = float(first_sf.numel()) if use_reg else 0.0
            totals = reduce(torch.stack([
                mass.detach(), torch.tensor(n, device=mass.device)]))
            mass, count = totals[0], totals[1]
        main, logs = masked_means(sums, mass, cfg)
        total = main * steps if cfg.weight_steps else main
        if use_reg:
            reg = acceleration_reg(first_sf, second_sf, cfg, count)
            total = total + reg
            logs["acc_reg"] = reg
        else:
            logs["acc_reg"] = torch.zeros((), device=main.device)
        return total, logs

    def train_step(self, batch: Dict[str, torch.Tensor], steps: int,
                   warm: bool, reduce: Optional[Reduce] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the logs as detached scalars on
        the device (the caller decides when to fetch them).

        With ``reduce`` the batch is this rank's share of a batch split
        over ranks: the losses take the ranks' denominators, the gradients
        are summed over the ranks in one flattened buffer before the
        optimizers step (the sum of the shares' gradients is the whole
        batch's), and the logs are summed too, so they are the whole
        batch's values."""
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)
        total, logs = self.loss_and_logs(batch, int(steps), bool(warm),
                                         reduce)
        total.backward()
        if reduce is not None:
            self._reduce_grads(reduce)
            keys = sorted(logs)
            summed = reduce(torch.stack([logs[k].detach() for k in keys]))
            logs = dict(zip(keys, summed.unbind()))
        if self.cfg.log_grad_stats:
            logs.update(self.grad_stats())
        for opt in self.optimizers:
            opt.step()
        return {k: v.detach() for k, v in logs.items()}

    def _reduce_grads(self, reduce: Reduce) -> None:
        """Sum every existing gradient over the ranks: one ``reduce`` of
        their concatenation, copied back. A net without gradients (the
        depth net in warm-up) has none on any rank."""
        grads = [p.grad for net in (self.net_depth, self.net_sf)
                 for p in net.parameters() if p.grad is not None]
        if not grads:
            return
        flat = reduce(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def grad_stats(self) -> Dict[str, torch.Tensor]:
        """Each net's global gradient norm and largest absolute gradient,
        device scalars (JAX step.py:613-622). A net without gradients (the
        depth net in warm-up) gives 0, as the JAX ``stop_gradient``
        does."""
        out = {}
        for name, net in (("depth", self.net_depth), ("sf", self.net_sf)):
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            zero = torch.zeros((), device=self.device)
            if grads:
                norms = torch.stack([torch.linalg.vector_norm(g)
                                     for g in grads])
                maxes = torch.stack([g.abs().max() for g in grads])
                out[f"grad_norm_{name}"] = torch.linalg.vector_norm(norms)
                out[f"grad_max_{name}"] = torch.maximum(maxes.max(), zero)
            else:
                out[f"grad_norm_{name}"] = out[f"grad_max_{name}"] = zero
        return out

    # ------------------------------------------------------ vali/test steps

    @torch.no_grad()
    def forward_vis(self, batch: Dict[str, torch.Tensor], steps: int):
        """The prediction dict of a training pair for visualization (JAX
        step.py:683-698): the unfused forward plus the per-pixel scene-flow
        residual ``sf_loss_pp`` (reference
        models/scene_flow_motion_field.py:306)."""
        pred, _, _ = self._forward(batch, int(steps), depth_grad=False)
        pred["sf_loss_pp"] = torch.sum(
            torch.abs(pred["sf_by_dep_1_2"] - pred["sf_1_2"]), dim=-1)
        return pred

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """Single-frame inference: depth and the one-step scene flow."""
        depth = self._apply_depth(batch["img"])
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
