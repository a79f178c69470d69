"""Depth evaluation metrics (counterpart of
``dynamic_video_depth_tpu/utils/metrics.py``).

The reference reports only the masked disparity MSE used for model
selection (models/video_base.py:66-74); the test entry adds the standard
monocular-depth metrics (AbsRel, RMSE, delta thresholds) over valid-GT
pixels."""

from __future__ import annotations

from typing import Dict

import numpy as np

METRIC_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "d1", "d2", "d3")


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  min_depth: float = 1e-2) -> Dict[str, float]:
    """Standard depth metrics over the pixels where ``gt > min_depth``
    (all NaN when there is none)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = gt > min_depth
    if valid.sum() == 0:
        return {k: float("nan") for k in METRIC_KEYS}
    p = np.clip(pred[valid], min_depth, None)
    g = gt[valid]
    thresh = np.maximum(p / g, g / p)
    return {
        "abs_rel": float(np.mean(np.abs(p - g) / g)),
        "sq_rel": float(np.mean((p - g) ** 2 / g)),
        "rmse": float(np.sqrt(np.mean((p - g) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(p) - np.log(g)) ** 2))),
        "d1": float(np.mean(thresh < 1.25)),
        "d2": float(np.mean(thresh < 1.25 ** 2)),
        "d3": float(np.mean(thresh < 1.25 ** 3)),
    }


def scale_invariant_alignment(pred: np.ndarray, gt: np.ndarray,
                              min_depth: float = 1e-2) -> float:
    """Median-ratio scale aligning ``pred`` to ``gt`` (the per-track
    calibration convention of preprocessing stage 1)."""
    valid = gt > min_depth
    if valid.sum() == 0:
        return 1.0
    return float(np.median(gt[valid] / np.clip(pred[valid], min_depth, None)))
