"""Golden check of a pretrained RAFT checkpoint through the port
(counterpart of ``scripts/raft_golden_check.py``), for the official
``raft-sintel.pth``, under the official protocol: 288x512, 20 iterations
(reference scripts/preprocess/davis/generate_flows.py:127,134).

    python -m dynamic_video_depth_tpu_torch.tools.golden_raft \\
        --ckpt raft-sintel.pth --freeze      # once
    python -m dynamic_video_depth_tpu_torch.tools.golden_raft \\
        --ckpt raft-sintel.pth               # every check after

Protocol, step for step the JAX script's:

1. sha256 the checkpoint; a golden frozen for another checksum is refused
   (exit 2).
2. The input: a seeded ``(h+8, w+8, 3)`` field x 255
   (``RandomState(1234)``), the pair ``[:h, :w]`` and ``[3:3+h, 2:2+w]``
   (a rigid 2-3 px shift), or ``--frames A B`` resized bilinearly.
3. The forward flow comes through the production path:
   ``preprocess/flows.py::make_raft_flow_fn(ckpt)`` at ``--res`` and
   ``--iters`` (the loader raises on a key it does not consume). On the
   card each call launches the correlation lookup kernel once an
   iteration; the harness prints the launches.
4. On the card (the default) the same pair also runs on the CPU; the
   end-point error (mean of the per-pixel distance) must stay below
   ``--tol`` px. On ``--device cpu`` that comparison is skipped and said
   to be.
5. ``--freeze`` writes the golden with the JAX script's keys (``flow``,
   ``checksum``, ``res``, ``iters``) and ``device``; else a golden
   present is rechecked, an EPE above ``--tol`` exits 1. A golden frozen
   by the JAX script is given with ``--golden``.

Exit codes: ``tools/golden.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..preprocess import flows
from . import golden

RAFT_RES = (288, 512)  # official protocol (generate_flows.py:127)
RAFT_ITERS = 20        # official protocol (generate_flows.py:134)
sha256 = golden.sha256


def protocol_inputs(frames: Optional[Sequence[str]], res=RAFT_RES):
    """The protocol's pair of ``[h, w, 3]`` float32 images in [0, 255]."""
    h, w = res
    if frames:
        ims = [golden.resize_image(golden.read_image(p), res)
               for p in frames]
        return ims[0], ims[1]
    rng = np.random.RandomState(1234)
    base = rng.rand(h + 8, w + 8, 3).astype(np.float32) * 255.0
    return base[:h, :w], base[3:3 + h, 2:2 + w]


def epe(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.linalg.norm(a - b, axis=-1)))


def lookup_launches() -> int:
    from ..ops.cuda import corr_kernel

    return corr_kernel.launches["corr_lookup"]


def flow(ckpt: str, im1: np.ndarray, im2: np.ndarray, res=RAFT_RES,
         iters: int = RAFT_ITERS, device: str = "cuda") -> np.ndarray:
    """The ``[h, w, 2]`` forward flow of the pair through
    ``make_raft_flow_fn``."""
    with golden.module_attrs(flows, RAFT_RES=tuple(res), RAFT_ITERS=iters):
        flow_fn = flows.make_raft_flow_fn(ckpt, device=device)
        dev = torch.device(device)
        fwd, _ = flow_fn(torch.from_numpy(np.ascontiguousarray(im1)).to(dev),
                         torch.from_numpy(np.ascontiguousarray(im2)).to(dev))
    return fwd.cpu().numpy()


def run(ckpt: str, golden_path: str, freeze: bool, tol: float,
        frames: Optional[Sequence[str]] = None, res=RAFT_RES,
        iters: int = RAFT_ITERS, device: str = "cuda") -> int:
    checksum = sha256(ckpt)
    print(f"checkpoint sha256: {checksum}")
    if golden.refused_checksum(golden_path, checksum, freeze):
        return golden.OTHER_ARTIFACT
    im1, im2 = protocol_inputs(frames, res)
    before = lookup_launches()
    out = golden.predict_safely(
        lambda d: flow(ckpt, im1, im2, res, iters, d), device)
    if out is None:
        return golden.UNSAFE_ARTIFACT
    print(f"RAFT at {res[0]}x{res[1]} x {iters} iterations on {device}: "
          f"corr_lookup launches {lookup_launches() - before}")
    cpu = None if torch.device(device).type == "cpu" else \
        flow(ckpt, im1, im2, res, iters, "cpu")
    return golden.check(out, cpu, golden_path, freeze, tol, epe, "EPE px",
                        "flow", dict(checksum=checksum, res=np.asarray(res),
                                     iters=iters, device=device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamic_video_depth_tpu_torch.tools.golden_raft")
    ap.add_argument("--ckpt", required=True, help="path to raft-sintel.pth")
    ap.add_argument("--golden", default=os.path.join(
        golden.GOLDEN_DIR, "torch_raft_sintel_golden.npz"))
    ap.add_argument("--freeze", action="store_true",
                    help="store the golden instead of checking against it")
    ap.add_argument("--tol", type=float, default=0.05, help="EPE tol (px)")
    ap.add_argument("--frames", nargs=2, default=None,
                    help="two image files to use instead of the synthetic "
                    "pair")
    ap.add_argument("--res", type=int, nargs=2, default=list(RAFT_RES))
    ap.add_argument("--iters", type=int, default=RAFT_ITERS)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' needs a GPU")
    a = ap.parse_args(argv)
    return run(a.ckpt, a.golden, a.freeze, a.tol, a.frames, tuple(a.res),
               a.iters, a.device)


if __name__ == "__main__":
    raise SystemExit(main())
