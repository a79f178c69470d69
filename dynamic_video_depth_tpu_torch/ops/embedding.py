"""Fourier embedding of the scene-flow field's inputs (counterpart of
``dynamic_video_depth_tpu/ops/embedding.py``).

``sceneflow_features`` is the plain form; ``sceneflow_embed_consts`` builds
the constant tables that linearize it for the embedded-MLP kernel
(``ops/cuda/mlp_kernel.py``)::

    ang  = pts @ f_xyz + ts @ f_t
    feat = raw * ang + cos_m * cos(ang) + sin_m * sin(ang)

The tables are built in numpy float32 with the same arithmetic as the JAX
package, so both packages hold bit-equal constants.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """numpy float32 replica of ``jnp.linspace``:
    ``start*(1-step) + stop*step`` with ``step = arange(div)/div`` and the
    endpoint appended exactly."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start * (np.float32(1.0) - step) + stop * step
    return np.append(out, stop).astype(np.float32)


def periodic_embed(x: torch.Tensor, max_freq: int, n_freq: int,
                   linspace: bool = True) -> torch.Tensor:
    """``[..., C] -> [..., C * (1 + 2 * n_freq)]`` with channel order
    ``[x, cos(f1 x)..cos(fN x), sin(f1 x)..sin(fN x)]``, freq-major within
    each function block (reference PeriodicEmbed): frequencies
    ``linspace(1, max_freq + 1, n_freq)``, or ``2 ** arange(n_freq)`` without
    ``linspace``."""
    if n_freq == 0:
        return x
    table = (_linspace_f32(1.0, max_freq + 1.0, n_freq) if linspace
             else 2.0 ** np.arange(n_freq, dtype=np.float32))
    freqs = torch.from_numpy(table).to(device=x.device, dtype=x.dtype)
    ang = x[..., None, :] * freqs[:, None]
    flat = x.shape[:-1] + (n_freq * x.shape[-1],)
    return torch.cat(
        [x, torch.cos(ang).reshape(flat), torch.sin(ang).reshape(flat)], dim=-1)


def sceneflow_features(pts: torch.Tensor, ts, n_freq_xyz: int, n_freq_t: int,
                       time_dependent: bool) -> torch.Tensor:
    """Input features of the scene-flow field: ``cat([t_emb, xyz_emb])``."""
    xyz_emb = periodic_embed(pts, n_freq_xyz, n_freq_xyz)
    if not time_dependent:
        return xyz_emb
    return torch.cat([periodic_embed(ts, n_freq_t, n_freq_t), xyz_emb], dim=-1)


@functools.lru_cache(maxsize=None)
def _embed_block(n_in: int, n_freq: int):
    """``(F [n_in, width], raw, cos, sin [width])`` for one periodic_embed
    block; every column of F has exactly one nonzero, so ``x @ F`` adds only
    structural zeros."""
    if n_freq == 0:
        return (np.eye(n_in, dtype=np.float32), np.ones(n_in, np.float32),
                np.zeros(n_in, np.float32), np.zeros(n_in, np.float32))
    freqs = _linspace_f32(1.0, n_freq + 1.0, n_freq)
    width = n_in * (1 + 2 * n_freq)
    F = np.zeros((n_in, width), np.float32)
    raw = np.zeros(width, np.float32)
    cosm = np.zeros(width, np.float32)
    sinm = np.zeros(width, np.float32)
    for c in range(n_in):
        F[c, c] = 1.0
        raw[c] = 1.0
    for i, f in enumerate(freqs):
        for c in range(n_in):
            col = n_in + i * n_in + c
            F[c, col] = f
            cosm[col] = 1.0
            col = n_in + (n_freq + i) * n_in + c
            F[c, col] = f
            sinm[col] = 1.0
    return F, raw, cosm, sinm


def sceneflow_embed_consts(n_freq_xyz: int, n_freq_t: int,
                           time_dependent: bool):
    """``(f_xyz [3,C], f_t [1,C], raw, cos_m, sin_m [1,C])`` numpy float32
    tables with C and channel order identical to ``sceneflow_features``
    (C = 132 at 16/16 frequencies). For ``time_dependent=False`` the t
    table is zero."""
    fx, raw_x, cos_x, sin_x = _embed_block(3, n_freq_xyz)
    if not time_dependent:
        f_t = np.zeros((1, fx.shape[1]), np.float32)
        return (fx, f_t, raw_x[None], cos_x[None], sin_x[None])
    ft, raw_t, cos_t, sin_t = _embed_block(1, n_freq_t)
    ct, cx = ft.shape[1], fx.shape[1]
    f_t = np.concatenate([ft, np.zeros((1, cx), np.float32)], axis=1)
    f_xyz = np.concatenate([np.zeros((3, ct), np.float32), fx], axis=1)

    def cat(a, b):
        return np.concatenate([a, b])[None]

    return (f_xyz, f_t, cat(raw_t, raw_x), cat(cos_t, cos_x),
            cat(sin_t, sin_x))
