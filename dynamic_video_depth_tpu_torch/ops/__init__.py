"""Geometry, warp and embedding ops; hand-written CUDA kernels in ``cuda``."""

from .camera import Camera, camera_from_packed, packed_from_camera
from .geometry import (
    camera_to_world,
    depth_warp_stage,
    flow_by_depth,
    project,
    project_displacement,
    projection_stage,
    rigidity_loss,
    scene_flow_projection,
    unproject,
    unproject_camera,
    world_to_camera,
)
from .cuda.warp_kernel import backward_warp
from .grid_sample import grid_sample

__all__ = [
    "Camera", "camera_from_packed", "camera_to_world", "depth_warp_stage",
    "flow_by_depth", "packed_from_camera", "project", "project_displacement",
    "projection_stage", "rigidity_loss", "scene_flow_projection",
    "unproject", "unproject_camera", "world_to_camera", "backward_warp",
    "grid_sample",
]
