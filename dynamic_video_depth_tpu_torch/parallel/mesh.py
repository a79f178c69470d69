"""The process layout (counterpart of
``dynamic_video_depth_tpu/parallel/mesh.py``).

One process per rank under ``torch.distributed``: NCCL on CUDA, gloo on
the CPU. A fleet of ``n_videos`` videos, each data-parallel over ``dp``
ranks, puts video ``vi``'s data index ``di`` on rank ``r = vi * dp + di``,
on ``cuda:r`` (or the CPU); the ranks of one video form its row, whose
process group carries that video's reductions.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(backend: Optional[str], init_method: str,
                           world_size: int, rank: int,
                           device: torch.device) -> None:
    """``dist.init_process_group`` for this rank (the reference's TCP
    rendezvous, train.py:138). On CUDA the rank's card becomes the current
    device first. ``backend`` ``None`` is NCCL on CUDA and gloo on the CPU;
    gloo may be named on CUDA too (its collectives stage through the
    host). A failed init raises: there is no CPU fallback."""
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


class Layout:
    """``n_videos`` rows of ``dp`` ranks: each rank's video, data index,
    device and row group. A CUDA layout needs a card per rank."""

    def __init__(self, n_videos: int, dp: int = 1, device_type: str = "cuda"):
        if n_videos < 1 or dp < 1:
            raise ValueError(f"a layout needs n_videos >= 1 and dp >= 1, got "
                             f"{n_videos} x {dp}")
        self.n_videos, self.dp = n_videos, dp
        self.device_type = device_type
        self.world_size = n_videos * dp
        if device_type == "cuda":
            have = torch.cuda.device_count()
            if self.world_size > have:
                raise ValueError(f"{n_videos} videos x dp {dp} need "
                                 f"{self.world_size} CUDA devices, have "
                                 f"{have}")
        self._groups: Optional[List] = None

    def video(self, rank: int) -> int:
        return rank // self.dp

    def data_index(self, rank: int) -> int:
        return rank % self.dp

    def row(self, video: int) -> List[int]:
        """The ranks of ``video``, in data order."""
        return list(range(video * self.dp, (video + 1) * self.dp))

    def device(self, rank: int) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", rank)
        return torch.device(self.device_type)

    def row_group(self, rank: int):
        """The process group of ``rank``'s row. The first call makes every
        row's group, in video order, on every rank (``dist.new_group`` is
        collective: each rank must make each group, in the same order)."""
        if self._groups is None:
            self._groups = [dist.new_group(self.row(v))
                            for v in range(self.n_videos)]
        return self._groups[self.video(rank)]
