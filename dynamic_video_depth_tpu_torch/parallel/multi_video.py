"""Several videos at once, and one video over several ranks (counterpart of
``dynamic_video_depth_tpu/parallel/multi_video.py``).

The reference's multi-GPU DDP is broken (reference train.py:284-292,
SURVEY §2.2); as in the JAX package it is replaced by two schemes, here
over ``torch.distributed`` with one process per rank:

1. ``MultiVideoOptimizer``: one video per rank. Each rank runs the plain
   single-video step on its own video; the step has no collective. The
   fleet starts from one state, rank 0's, broadcast once.
2. ``DataParallelStep``: one video's pair batch split over the ranks of a
   process group, parameters equal on every rank. Each rank's losses
   divide its own sums by the group's total mask mass, and after the
   backward pass one all-reduce (SUM) of the flattened gradients gives
   every rank the gradient of the whole batch's loss: the single-process
   step's numerics, which a mean of per-rank losses or gradients would
   not give. DDP is not used: it averages gradients, and the depth net has
   none in warm-up.

``MultiVideoDataParallel`` puts the two together: V videos, each over its
row of D ranks (``mesh.Layout``), every reduction inside the row's group.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..data.batches import to_device
from .mesh import Layout


def step_tensors(step) -> List[torch.Tensor]:
    """The parameters and buffers of a step's two nets, in a fixed order."""
    return [t for net in (step.net_depth, step.net_sf)
            for t in list(net.parameters()) + list(net.buffers())]


@torch.no_grad()
def broadcast_tensors(tensors, src: int, group=None) -> None:
    """Overwrite ``tensors`` with rank ``src``'s: one broadcast of their
    concatenation per dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_bounds(n: int, size: int, index: int):
    """``[lo, hi)`` of rank ``index``'s share of ``n`` rows split in order
    over ``size`` ranks; ``n`` must divide evenly."""
    if n % size:
        raise ValueError(f"leading dim {n} is not divisible by the data "
                         f"group's size {size}; refusing to split unevenly")
    k = n // size
    return index * k, (index + 1) * k


class MultiVideoOptimizer:
    """One video per rank, no collective in the step."""

    def __init__(self, step):
        self.step = step

    def broadcast_state(self, src: int = 0) -> None:
        """Every video starts from rank ``src``'s nets (JAX
        ``_broadcast_state``); the optimizers hold no state before their
        first step."""
        broadcast_tensors(step_tensors(self.step), src)

    def train_step(self, batch, steps: int, warm: bool):
        return self.step.train_step(batch, steps, warm)

    def vali_step(self, batch):
        return self.step.vali_step(batch)


class DataParallelStep:
    """One video's batch split over the ranks of ``group`` (the world when
    ``None``). With ``timed`` every reduction is timed between device
    synchronizations and recorded in ``reductions`` as (bytes, ms)."""

    def __init__(self, step, group=None, timed: bool = False):
        self.step = step
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.src = dist.get_global_rank(group, 0) if group is not None else 0
        self.timed = timed
        self.reductions: List[tuple] = []

    def place(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """This rank's share of a whole host batch (numpy, as
        ``collate_batches`` gives it) as tensors on the step's device:
        every array with a leading dimension split in order, scalars kept.
        A leading dimension that the group's size does not divide raises
        ``ValueError`` before anything is moved (no silent replication)."""
        bounds = {k: shard_bounds(v.shape[0], self.size, self.index)
                  for k, v in batch.items()
                  if isinstance(v, np.ndarray) and v.ndim}
        return to_device({k: v[slice(*bounds[k])] if k in bounds else v
                          for k, v in batch.items()}, self.step.device)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns it."""
        if self.timed:
            _sync(t.device)
            t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        if self.timed:
            _sync(t.device)
            self.reductions.append((t.numel() * t.element_size(),
                                    1e3 * (time.perf_counter() - t0)))
        return t

    def broadcast_state(self) -> None:
        """The group's first rank's nets on every rank of the group."""
        broadcast_tensors(step_tensors(self.step), self.src, self.group)

    def train_step(self, batch, steps: int, warm: bool):
        """One step on this rank's share; the logs are the whole batch's."""
        return self.step.train_step(batch, steps, warm, reduce=self.reduce)

    def vali_step(self, batch):
        """Every rank holds the same frame (JAX train_fleet.py:262-266):
        the loss is the group's mean, the loss of that one frame."""
        pred, logs = self.step.vali_step(batch)
        loss = self.reduce(logs["loss"].detach().clone()) / self.size
        return pred, {"loss": loss}


class MultiVideoDataParallel(DataParallelStep):
    """V videos, each data-parallel over its row of the layout: this rank
    reduces within its row's group only."""

    def __init__(self, step, layout: Layout, timed: bool = False):
        rank = dist.get_rank()
        super().__init__(step, layout.row_group(rank), timed)
        self.layout = layout
        self.video = layout.video(rank)

    def broadcast_state(self, src: int = 0) -> None:
        """Every video starts from rank ``src``'s nets (the JAX fleet's
        ``broadcast_state``): one broadcast over the world."""
        broadcast_tensors(step_tensors(self.step), src)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


__all__ = ["DataParallelStep", "MultiVideoDataParallel",
           "MultiVideoOptimizer", "broadcast_tensors", "shard_bounds",
           "step_tensors"]
