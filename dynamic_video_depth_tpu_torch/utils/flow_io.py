"""Middlebury ``.flo`` optical-flow files (counterpart of
``dynamic_video_depth_tpu/utils/flow_io.py``; reference
util/util_flow.py:22-73 ``readFlow``/``writeFlow``).

Layout: float32 magic 202021.25, int32 width, int32 height, then
``h * w * 2`` float32 values, (u, v) interleaved, row-major, little-endian.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a ``.flo`` file -> ``[H, W, 2]`` float32 (u, v); a bad magic
    number or a short file raises ``ValueError``."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", count=1)
        if magic.size != 1 or magic[0] != _MAGIC:
            raise ValueError(f"{path}: invalid .flo magic {magic!r}")
        w = int(np.fromfile(f, "<i4", count=1)[0])
        h = int(np.fromfile(f, "<i4", count=1)[0])
        data = np.fromfile(f, "<f4", count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"{path}: truncated .flo ({data.size} values)")
        return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write ``flow [H, W, 2]`` (u, v) as a ``.flo`` file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.asarray([_MAGIC], "<f4").tofile(f)
        np.asarray([w], "<i4").tofile(f)
        np.asarray([h], "<i4").tofile(f)
        flow.astype("<f4").tofile(f)
