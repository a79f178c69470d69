"""Depth nets, the scene-flow field and its CNN alternative, and the
library blocks and MLPs (the JAX package's ``models`` exports), and the
``--net`` registry."""

import importlib

from .blocks import ConvBlock, DoubleConvBlock, PeriodicEmbed, ResConv2DBlock
from .dpt import DPTDepthNet
from .fcn_unet import FCNUnet
from .hourglass import HourglassModel, HourglassModelEmbed
from .midas import MidasNet
from .mlp import MLP, EmbeddedMLP
from .sceneflow_field import SceneFlowFieldNet
from .tiny import TinyDepthNet


def get_model(alias: str):
    """``--net`` alias -> the trainer's ``Model`` class,
    ``dynamic_video_depth_tpu_torch.train.<alias>.Model`` (reference
    models/__init__.py:18-20)."""
    module = importlib.import_module(
        "dynamic_video_depth_tpu_torch.train." + alias)
    return module.Model


__all__ = ["ConvBlock", "DPTDepthNet", "DoubleConvBlock", "EmbeddedMLP",
           "FCNUnet", "HourglassModel", "HourglassModelEmbed", "MLP",
           "MidasNet", "PeriodicEmbed", "ResConv2DBlock",
           "SceneFlowFieldNet", "TinyDepthNet", "get_model"]
