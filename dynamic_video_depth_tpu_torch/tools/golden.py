"""What the two golden checks share (``golden_depth``, ``golden_raft``):
the checkpoint's checksum, the real-image input, and the protocol's steps
after the prediction (the card against the CPU, freeze, recheck).

Exit codes, as the JAX scripts': 0 the check passed; 1 the card and the CPU
part by more than ``--tol``, or the prediction drifted from the golden by
more than ``--tol``; 2 the golden was frozen for another checkpoint (its
sha256 differs); 3 the port's safe loader refused the checkpoint (below).

The loader stays safe. ``runtime/weights.py`` reads a checkpoint with
``torch.load(..., weights_only=True)``: unpickling can run code, and the
official artifacts are tensors in dicts. Should an artifact pickle another
object, the harness exits 3 and names it; nothing here retries with
``weights_only=False``. Allow such a type by name
(``torch.serialization.add_safe_globals``) once it has been read and found
harmless.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.resize import resize_bilinear

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
PASS, DRIFT, OTHER_ARTIFACT, UNSAFE_ARTIFACT = 0, 1, 2, 3


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def read_image(path: str) -> np.ndarray:
    """An image file as float32 ``[H, W, 3]`` in [0, 255]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def resize_image(im: np.ndarray, res) -> np.ndarray:
    """Bilinear, align_corners=False (``ops/resize.py``), on the CPU, in
    float64 so that the source positions are those of the JAX package's
    float64 matrices (float32 positions part from them by up to 1.5e-6 at
    224x384); float32 out."""
    x = torch.from_numpy(np.asarray(im, np.float64))[None]
    return resize_bilinear(x, tuple(res), False)[0].numpy().astype(
        np.float32)


@contextlib.contextmanager
def module_attrs(module, **values):
    """Set module-level settings (a checkpoint path, RAFT's size) as the
    entry points read them, and restore them on the way out."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def refused_checksum(golden: str, checksum: str, freeze: bool) -> bool:
    """Step 1: a golden frozen for another artifact is not compared."""
    if freeze or not os.path.isfile(golden):
        return False
    with np.load(golden, allow_pickle=False) as gd:
        stored = str(gd["checksum"])
    if stored != checksum:
        print(f"FAIL: golden was frozen for checksum {stored}; this "
              f"artifact differs: refusing to compare")
        return True
    return False


def predict_safely(predict: Callable[[str], np.ndarray], device: str):
    """``predict(device)``, or ``None`` after naming what the safe loader
    refused (exit 3)."""
    try:
        return predict(device)
    except pickle.UnpicklingError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        why = [ln for ln in lines if "Unpickler" in ln] or lines[:1]
        print("FAIL: the checkpoint pickles an object that is not a tensor, "
              "and the port's loader (runtime/weights.py, "
              "torch.load weights_only=True) refuses it: "
              f"{why[0] if why else e}. Allow that type by name "
              "(torch.serialization.add_safe_globals) after reading what "
              "it is; the loader does not fall back to weights_only=False")
        return None


def check(out: np.ndarray, cpu: Optional[np.ndarray], golden: str,
          freeze: bool, tol: float, metric: Callable, metric_name: str,
          key: str, meta: Dict) -> int:
    """Steps 4-5: the card's prediction against the CPU's (``cpu`` is None
    on the CPU), then freeze ``{key: out, **meta}`` or recheck against the
    golden's ``key``."""
    if cpu is None:
        print("card vs CPU: skipped (the prediction ran on the CPU)")
    else:
        e = metric(out, cpu)
        print(f"{metric_name} card-vs-CPU: {e:.3e} (tol {tol})")
        if e > tol:
            print("FAIL: the card does not reproduce the CPU")
            return DRIFT
    if freeze:
        os.makedirs(os.path.dirname(os.path.abspath(golden)), exist_ok=True)
        np.savez(golden, **{key: out}, **meta)
        print(f"froze golden -> {golden}")
        return PASS
    if os.path.isfile(golden):
        with np.load(golden, allow_pickle=False) as gd:
            e_g = metric(out, gd[key])
        print(f"{metric_name} vs frozen golden: {e_g:.3e} (tol {tol})")
        if e_g > tol:
            print("FAIL: the port drifted from the frozen golden")
            return DRIFT
    else:
        print("note: no golden file yet; run with --freeze to store one")
    print("PASS")
    return PASS
