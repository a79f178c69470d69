"""Depth nets, the scene-flow field and its CNN alternative, and the
library blocks and MLPs (the JAX package's ``models`` exports)."""

from .blocks import ConvBlock, DoubleConvBlock, PeriodicEmbed
from .fcn_unet import FCNUnet
from .hourglass import HourglassModel, HourglassModelEmbed
from .midas import MidasNet
from .mlp import MLP, EmbeddedMLP
from .sceneflow_field import SceneFlowFieldNet
from .tiny import TinyDepthNet

__all__ = ["ConvBlock", "DoubleConvBlock", "EmbeddedMLP", "FCNUnet",
           "HourglassModel", "HourglassModelEmbed", "MLP", "MidasNet",
           "PeriodicEmbed", "SceneFlowFieldNet", "TinyDepthNet"]
