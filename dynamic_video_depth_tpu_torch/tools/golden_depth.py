"""Golden check of a pretrained depth checkpoint through the port
(counterpart of ``scripts/depth_golden_check.py``): MiDaS
``midas_cpkt.pt`` or the hourglass
``best_depth_Ours_Bilinear_inc_3_net_G.pth``.

    python -m dynamic_video_depth_tpu_torch.tools.golden_depth \\
        --net midas --ckpt midas_cpkt.pt --freeze      # once
    python -m dynamic_video_depth_tpu_torch.tools.golden_depth \\
        --net midas --ckpt midas_cpkt.pt               # every check after

Protocol, step for step the JAX script's:

1. sha256 the checkpoint; a golden frozen for another checksum is refused
   (exit 2).
2. The input: a seeded ``(h/16+1, w/16+1, 3)`` field
   (``RandomState(1234)``) resized bilinearly (align_corners=False) to
   224x384, or ``--image`` resized so.
3. The prediction goes through the production loader: the trainer's
   ``Model`` (``train/scene_flow_motion_field.py``) with the checkpoint
   path set where the trainer reads it (``runtime/weights.py``), then the
   step's depth path in float32 (the step turns TF32 off).
4. On the card (the default) the same net also runs on the CPU; the
   relative error (max |a - b| / max |b|) must stay below ``--tol``. On
   ``--device cpu`` that comparison is skipped and said to be.
5. ``--freeze`` writes the golden with the JAX script's keys
   (``prediction``, ``checksum``, ``res``, ``net``) and ``device``; else a
   golden present is rechecked, drift above ``--tol`` exits 1. A golden
   frozen by the JAX script is given with ``--golden``.

Exit codes: ``tools/golden.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..runtime import weights
from . import golden

RES = (224, 384)  # the reference's working resolution
sha256 = golden.sha256


def protocol_image(image: Optional[str], res=RES) -> np.ndarray:
    """The protocol's ``[h, w, 3]`` float32 image in [0, 1]."""
    h, w = res
    if image:
        return golden.resize_image(golden.read_image(image) / 255.0, res)
    rng = np.random.RandomState(1234)
    # a smooth low-frequency field: depth nets see natural images, not noise
    base = rng.rand(h // 16 + 1, w // 16 + 1, 3).astype(np.float32)
    return golden.resize_image(base, res)


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def model_options(net: str, device: str) -> argparse.Namespace:
    """The train entry's defaults for ``net``: only the depth net is read."""
    from ..train import cli

    return cli.build_parser().parse_args(
        ["--depth_net", net, "--time_dependent", "--use_disp",
         "--device", device])


def prediction(net: str, ckpt: str, img: np.ndarray,
               device: str = "cuda") -> np.ndarray:
    """The ``[h, w]`` depth of ``img`` through the production loader."""
    from ..train.scene_flow_motion_field import Model

    path = "MIDAS_PRETRAIN_PATH" if net == "midas" else \
        "DEPTH_PRETRAIN_PATH"
    with golden.module_attrs(weights, **{path: ckpt}):
        model = Model(model_options(net, device), device=device)
    if not model.used_pretrained:
        raise RuntimeError(f"the production loader did not consume {ckpt}")
    x = torch.from_numpy(np.ascontiguousarray(img[None], np.float32))
    with torch.no_grad():
        depth = model.step._apply_depth(x.to(model.step.device))
    return depth[0].cpu().numpy()


def run(net: str, ckpt: str, golden_path: str, freeze: bool, tol: float,
        image: Optional[str] = None, res=RES, device: str = "cuda") -> int:
    checksum = sha256(ckpt)
    print(f"checkpoint sha256: {checksum}")
    if golden.refused_checksum(golden_path, checksum, freeze):
        return golden.OTHER_ARTIFACT
    img = protocol_image(image, res)
    out = golden.predict_safely(
        lambda d: prediction(net, ckpt, img, d), device)
    if out is None:
        return golden.UNSAFE_ARTIFACT
    cpu = None if torch.device(device).type == "cpu" else \
        prediction(net, ckpt, img, "cpu")
    print(f"{net} depth at {res[0]}x{res[1]} on {device}: "
          f"range {out.min():.4g} .. {out.max():.4g}")
    return golden.check(out, cpu, golden_path, freeze, tol, rel_err,
                        "rel_err", "prediction",
                        dict(checksum=checksum, res=np.asarray(res),
                             net=net, device=device))


def default_golden(net: str) -> str:
    return os.path.join(golden.GOLDEN_DIR, f"torch_depth_{net}_golden.npz")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.tools.golden_depth")
    ap.add_argument("--net", choices=("midas", "hourglass"), required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--golden", default=None,
                    help="default tests/goldens/torch_depth_<net>_golden.npz")
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--image", default=None,
                    help="a real image file instead of the synthetic input")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' needs a GPU")
    a = ap.parse_args(argv)
    return run(a.net, a.ckpt, a.golden or default_golden(a.net), a.freeze,
               a.tol, a.image, RES, a.device)


if __name__ == "__main__":
    raise SystemExit(main())
