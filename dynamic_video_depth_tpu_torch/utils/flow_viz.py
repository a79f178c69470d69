"""Optical-flow visualization: the Middlebury colour wheel (counterpart of
``dynamic_video_depth_tpu/utils/flow_viz.py``; reference
util/util_flow.py:22-142, the Baker et al. colour coding)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _make_color_wheel() -> np.ndarray:
    """55-entry RYGCBM wheel, ``[ncols, 3]`` in 0..255."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col:col + ry, 0] = 255
    wheel[col:col + ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray,
                  max_flow: Optional[float] = None) -> np.ndarray:
    """``[H, W, 2]`` flow -> ``[H, W, 3]`` uint8 Middlebury visualization."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-9)
    u = u / maxrad
    v = v / maxrad
    rad = np.sqrt(u * u + v * v)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    inside = rad <= 1
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(inside, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img
