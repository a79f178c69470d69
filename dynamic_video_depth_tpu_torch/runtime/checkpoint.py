"""Checkpoints and the run's option snapshot (counterpart of
``dynamic_video_depth_tpu/runtime/checkpoint.py``; reference
models/netinterface.py:528-562, train.py:150-186).

A checkpoint is the reference's torch format, the one the JAX package's
``runtime/migrate.py`` reads::

    {'nets': [depth_sd, sceneflow_sd],
     'optimizers': [adam_depth_sd, adam_scene_sd],  # absent: weights only
     'epoch': N, 'best': b}

A run writes ``checkpoint.pt`` (every ``--save_every`` epochs and at its
last epoch), ``best.pt`` (on a better validation loss) and ``nets/%04d.pt``
(every ``--save_net`` epochs, weights only unless ``--save_net_opt``),
with ``opt.json`` and ``opt.txt`` beside them. Every file is written to a
temporary file in its directory and then renamed over the target. Saves
are synchronous, as the reference's are.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import torch


def _atomic(path: str, write) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(path: str, step, epoch: int = 0,
                    best: float = float("inf"),
                    include_opt: bool = True) -> None:
    """Write a ``SceneFlowMotionFieldStep``'s nets (and, with
    ``include_opt``, both Adams) to ``path`` atomically."""
    ckpt = {"nets": [step.net_depth.state_dict(), step.net_sf.state_dict()],
            "epoch": int(epoch), "best": float(best)}
    if include_opt:
        ckpt["optimizers"] = [o.state_dict() for o in step.optimizers]
    _atomic(path, lambda f: torch.save(ckpt, f))


def read_checkpoint(path: str, mmap: bool = False) -> Dict:
    """The checkpoint dict on the CPU (``mmap``: storages are mapped, not
    read, which suits reading one scalar out of a large file)."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def load_checkpoint(path: str, step, load_optimizer="auto") -> Dict:
    """Load a reference-format checkpoint into ``step``: both nets with
    ``strict=True``, and both Adams when the file has them (``'auto'``) or
    when ``load_optimizer`` is true (a file without them then raises).
    Returns the file's other entries (``epoch``, ``best``, ...)."""
    ckpt = read_checkpoint(path)
    nets = ckpt["nets"]
    if len(nets) != 2:
        raise ValueError(f"{path}: expected [net_depth, net_sceneflow], got "
                         f"{len(nets)} nets")
    step.net_depth.load_state_dict(nets[0], strict=True)
    step.net_sf.load_state_dict(nets[1], strict=True)
    if load_optimizer == "auto":
        load_optimizer = "optimizers" in ckpt
    if load_optimizer:
        for opt, sd in zip(step.optimizers, ckpt["optimizers"], strict=True):
            opt.load_state_dict(sd)
    return {k: v for k, v in ckpt.items() if k not in ("nets", "optimizers")}


def read_best(path: str) -> Optional[float]:
    """The ``best`` value recorded in a checkpoint, or ``None`` when the
    file is absent."""
    if not os.path.isfile(path):
        return None
    return float(read_checkpoint(path, mmap=True).get("best", float("inf")))


def save_opt(logdir: str, opt) -> None:
    """The run's options as ``opt.json`` and ``opt.txt`` (reference saves
    opt.pt and opt.txt, train.py:93-96)."""
    d = {k: v for k, v in vars(opt).items() if not k.startswith("_")}
    text = json.dumps(d, indent=1, default=str).encode()
    _atomic(os.path.join(logdir, "opt.json"), lambda f: f.write(text))
    lines = "".join(f"{k}: {d[k]}\n" for k in sorted(d)).encode()
    _atomic(os.path.join(logdir, "opt.txt"), lambda f: f.write(lines))


def load_opt(logdir: str) -> Dict:
    with open(os.path.join(logdir, "opt.json")) as f:
        return json.load(f)


def resolve_resume(logdir: str, resume: int) -> Optional[str]:
    """The reference's resume convention (train.py:243-274) as a path:
    0 = fresh (``None``), -1 = the last checkpoint, -2 = the best, N = the
    nets of epoch N."""
    if resume == 0:
        return None
    if resume == -1:
        return os.path.join(logdir, "checkpoint.pt")
    if resume == -2:
        return os.path.join(logdir, "best.pt")
    return os.path.join(logdir, "nets", "%04d.pt" % resume)
