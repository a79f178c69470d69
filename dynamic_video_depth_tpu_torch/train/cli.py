"""Training entry: ``python -m dynamic_video_depth_tpu_torch.train``
(counterpart of the JAX package's ``train.py``).

Takes the flag names of ``experiments/davis/train_sequence.sh`` that this
port implements, plus ``--device`` (default ``cuda``). The depth net is
``--depth_net`` when given, else MiDaS with ``--midas`` and the hourglass
without; the MiDaS far-field loss masks follow the same choice.
``--use_pallas_sf_chain`` and ``--use_pallas_loss`` (``auto|on|off``, the
JAX names) pick the fused chain and fused loss paths: ``auto`` is on for
``--device cuda`` and off on the CPU, where ``on`` runs the kernels' plain
versions. Settings the port does not implement yet raise instead of being
ignored: ``--use_cnn``, ``--mixed_precision_training``, ``--n_chips``,
``--resume`` and ``--load_reference_ckpt``; any other unknown flag is an
argparse error. Per-step losses go to stdout; checkpoints are not written
yet, and MiDaS starts from random weights (the pretrained checkpoint is not
loaded yet).

Example (the canonical DAVIS recipe with MiDaS)::

  python -m dynamic_video_depth_tpu_torch.train --net scene_flow_motion_field \\
      --dataset davis_sequence --track_id dog --log_time --epoch_batches 2000 \\
      --epoch 20 --lr 1e-6 --vali_batches 150 --batch_size 1 --optim adam \\
      --scene_lr_mul 1000 --warm_sf 5 --acc_mul 1 --disp_mul 1 --flow_mul 1 \\
      --sf_mag_div 100 --time_dependent --gaps 1,2,4,6,8 --use_disp --midas
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.davis_sequence import Dataset
from ..runtime.device import resolve_device
from .loop import Trainer
from .losses import LossConfig
from .step import (FUSED_MODES, SceneFlowMotionFieldStep, TrainStepConfig,
                   effective_depth_net)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamic_video_depth_tpu_torch.train")
    a = p.add_argument
    a("--net", default="scene_flow_motion_field",
      choices=["scene_flow_motion_field"])
    a("--dataset", default="davis_sequence", choices=["davis_sequence"])
    Dataset.add_arguments(p)
    a("--device", default="cuda", help="torch device; 'cuda' needs a GPU")
    a("--manual_seed", type=int, default=None)
    a("--epoch", type=int, default=0)
    a("--epoch_batches", type=int, default=None)
    a("--vali_batches", type=int, default=None)
    a("--batch_size", type=int, default=16)
    a("--no_batching", action="store_true",
      help="one sample per step whatever --batch_size says")
    a("--log_time", action="store_true",
      help="kept for the recipe; every step line carries its time")
    a("--optim", default="adam", choices=["adam"])
    a("--lr", type=float, default=1e-4)
    a("--adam_beta1", type=float, default=0.5)
    a("--adam_beta2", type=float, default=0.9)
    a("--init_type", default="kaiming")
    a("--scene_lr_mul", type=float, default=1.0)
    a("--warm_sf", type=int, default=0)
    a("--flow_mul", type=float, default=10.0)
    a("--disp_mul", type=float, default=10.0)
    a("--acc_mul", type=float, default=100.0)
    a("--sf_mag_div", type=float, default=100.0)
    a("--interp_steps", type=int, default=5)
    a("--n_freq_xyz", type=int, default=16)
    a("--n_freq_t", type=int, default=16)
    for flag in ("--time_dependent", "--use_disp", "--use_disp_ratio",
                 "--use_motion_seg", "--weight_steps", "--warm_reg"):
        a(flag, action="store_true")
    a("--midas", action="store_true", help="MiDaS depth net and loss masks")
    a("--depth_net", default="",
      help="'' defers to --midas; 'midas', 'hourglass' or 'tiny' (tests)")
    for knob in ("sf_chain", "loss"):
        a(f"--use_pallas_{knob}", choices=FUSED_MODES, default="auto",
          help="fused path: auto = on for a CUDA device, off on the CPU")
    # accepted only to refuse them: not ported yet
    for flag in ("--use_cnn", "--mixed_precision_training"):
        a(flag, action="store_true")
    a("--n_chips", type=int, default=None)
    a("--resume", type=int, default=0)
    a("--load_reference_ckpt", default="")
    return p


def _refuse_unported(opt) -> None:
    unported = {
        "--use_cnn": opt.use_cnn,
        "--mixed_precision_training": opt.mixed_precision_training,
        "--n_chips": opt.n_chips is not None,
        "--resume": opt.resume != 0,
        "--load_reference_ckpt": bool(opt.load_reference_ckpt),
    }
    given = [k for k, v in unported.items() if v]
    if given:
        raise NotImplementedError(
            f"not ported to the PyTorch package yet: {', '.join(given)}")


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


def build_trainer(argv: Optional[Sequence[str]] = None,
                  on_epoch_end=None) -> Trainer:
    """Parse the flags and build the step, the datasets and the trainer."""
    opt = build_parser().parse_args(argv)
    _refuse_unported(opt)
    device = resolve_device(opt.device)
    step = SceneFlowMotionFieldStep(step_config(opt), device=device,
                                    seed=opt.manual_seed or 0)
    train, vali = Dataset(opt, "train"), Dataset(opt, "vali")
    print(f"#train pairs: {len(train)}  #vali frames: {len(vali)}  "
          f"device: {device}", flush=True)
    return Trainer(step, train, vali, opt, on_epoch_end=on_epoch_end)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    return build_trainer(argv).train()
