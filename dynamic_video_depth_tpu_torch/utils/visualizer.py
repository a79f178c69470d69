"""Batch visualizer (counterpart of
``dynamic_video_depth_tpu/utils/visualizer.py``; reference
visualize/html_visualizer.py:24-120 and util/util_visualize.py routing).

Routes arrays by key substring: 'depth' -> turbo inverse depth, 'flow' ->
the Middlebury wheel, 'img' -> RGB as is. PNGs are encoded with the
standard library (``zlib`` + ``struct``, 8-bit RGB) on a thread pool, and
each output directory gets one accumulated ``index.html``.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import Dict, Optional

import numpy as np

from .colormap import depth_to_image
from .flow_viz import flow_to_image
from .html import ImageTable


def convert_for_display(key: str, value: np.ndarray) -> Optional[np.ndarray]:
    """Key-substring routing (reference: util/util_visualize.py:17,30-120);
    ``None`` for a key that is not drawn."""
    v = np.asarray(value)
    if v.ndim >= 4:  # drop the batch axis
        v = v[0]
    if "depth" in key:
        if v.ndim == 3:
            v = v[..., 0] if v.shape[-1] == 1 else v[0]
        return depth_to_image(v)
    if "flow" in key and v.ndim == 3 and v.shape[-1] == 2:
        return flow_to_image(v)
    if "img" in key:
        if v.ndim == 3 and v.shape[-1] == 3:
            return (np.clip(v, 0, 1) * 255).astype(np.uint8)
        if v.ndim == 3 and v.shape[0] == 3:
            return (np.clip(v.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    return None


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(rgb: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 -> PNG bytes (8-bit RGB, no filter)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


class HTMLVisualizer:
    """Visualization writer: PNG encodes on a thread pool (``zlib``
    releases the GIL), one accumulated page per output directory (= per
    epoch), a row per visualized batch whose cells follow the table's
    header (reference: visualize/html_visualizer.py:63-120). The page is
    rewritten after every batch, so it is current even if the run dies."""

    def __init__(self, n_workers: int = 4):
        self.pool = ThreadPoolExecutor(max_workers=max(n_workers, 1))
        self._pending = []
        self._tables: Dict[str, ImageTable] = {}

    def visualize(self, pack: Dict[str, np.ndarray], idx: int, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        written = {}
        for key, value in pack.items():
            if not isinstance(value, np.ndarray):
                continue
            img = convert_for_display(key, value)
            if img is None:
                continue
            fname = f"batch{idx:04d}_{key}.png"
            self._pending.append(
                self.pool.submit(write_png, join(outdir, fname), img))
            written[key] = fname
        if written:
            table = self._tables.get(outdir)
            if table is None:
                table = ImageTable(title=os.path.basename(outdir))
                table.set_header(["batch"] + sorted(written))
                self._tables[outdir] = table
            table.add_row([f"{idx:04d}"]
                          + [written.get(k, "") for k in table.header[1:]])
            table.save(join(outdir, "index.html"))
        return sorted(written.values())

    def flush(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        try:
            self.flush()
        finally:
            self.pool.shutdown()
