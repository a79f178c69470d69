"""Depth nets and the scene-flow field."""

from .hourglass import HourglassModel, HourglassModelEmbed
from .midas import MidasNet
from .sceneflow_field import SceneFlowFieldNet
from .tiny import TinyDepthNet

__all__ = ["HourglassModel", "HourglassModelEmbed", "MidasNet",
           "SceneFlowFieldNet", "TinyDepthNet"]
