"""Several videos and several ranks (counterpart of
``dynamic_video_depth_tpu/parallel``) over ``torch.distributed``: one
video per rank (``MultiVideoOptimizer``), one video's batch over a group of
ranks (``DataParallelStep``) and both at once (``MultiVideoDataParallel``);
``mesh`` lays the ranks out and initializes the process group."""

from .mesh import Layout, initialize_distributed
from .multi_video import (DataParallelStep, MultiVideoDataParallel,
                          MultiVideoOptimizer)

__all__ = [
    "Layout",
    "initialize_distributed",
    "MultiVideoOptimizer",
    "MultiVideoDataParallel",
    "DataParallelStep",
]
