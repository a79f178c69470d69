"""FCN-UNet scene-flow head (counterpart of
``dynamic_video_depth_tpu/models/fcn_unet.py``; reference
networks/FCNUnet.py:21-92).

The CNN alternative to the coordinate-MLP scene-flow field
(``--use_cnn``): an encoder of ``n_down`` blocks each followed by a 3x3
stride-2 average pool that counts the padded zeros (torch's
``AvgPool2d(3, 2, 1)``), a middle block, a decoder that upsamples 2x
bilinearly (``align_corners=True``) and concatenates the encoder's skip
before each block, and a 1x1 output conv. Images ``[B, H, W, C]`` in,
``[B, H, W, out_channel]`` out (H and W multiples of ``2 ** n_down``); the
blocks run in NCHW. Keys follow the JAX module's names (``down_00.model.0.
conv.weight``, ``mid_conv``, ``up_0000``, ``output_conv.conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample2x_nchw
from .blocks import ConvBlock, DoubleConvBlock

BLOCKS = {"conv": ConvBlock, "double_conv": DoubleConvBlock}


class FCNUnet(nn.Module):
    """The canonical instance (reference models/scene_flow_motion_field.py
    :105, JAX train/step.py): ``n_down=3, feat=32,
    block_type='double_conv', out_channel=3, norm='none',
    activation='lrelu', pad_type='reflect'`` on ``[pts, t]`` (4 channels)."""

    def __init__(self, in_channels: int, n_down: int = 4, feat: int = 32,
                 block_type: str = "conv", down_sample_type: str = "avgpool",
                 out_channel: int = 64, norm: str = "none",
                 activation: str = "lrelu", pad_type: str = "reflect",
                 output_activation: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        block = BLOCKS[block_type]
        kw = dict(kernel_size=3, padding=1, norm=norm, activation=activation,
                  pad_type=pad_type, generator=generator)
        self.n_down = n_down
        self.down_sample_type = down_sample_type
        self.output_activation = output_activation
        skips, ch, ch_out = [], in_channels, feat
        for k in range(n_down):
            setattr(self, f"down_{k:02d}", block(ch, ch_out, **kw))
            skips.append(ch_out)
            ch, ch_out = ch_out, ch_out * 2
        ch_in = ch_out // 2
        self.mid_conv = block(ch, ch_in, **kw)
        ch = ch_in
        for k in range(n_down - 1):
            setattr(self, f"up_{k:04d}",
                    block(skips[-(k + 1)] + ch, ch_in // 2, **kw))
            ch = ch_in = ch_in // 2
        setattr(self, f"up_{n_down - 1:04d}", block(skips[0] + ch, ch_in,
                                                    **kw))
        self.output_conv = ConvBlock(ch_in, out_channel, 1, norm="none",
                                     activation="none", pad_type=pad_type,
                                     generator=generator)

    def _pool(self, y: torch.Tensor) -> torch.Tensor:
        if self.down_sample_type == "avgpool":
            return F.avg_pool2d(y, 3, 2, 1, count_include_pad=True)
        if self.down_sample_type == "maxpool":
            return F.max_pool2d(y, 3, 2, 1)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for k in range(self.n_down):
            x = getattr(self, f"down_{k:02d}")(x)
            skips.append(x)
            x = self._pool(x)
        x = self.mid_conv(x)
        for k in range(self.n_down):
            up = upsample2x_nchw(x, align_corners=True)
            x = getattr(self, f"up_{k:04d}")(
                torch.cat([skips[-(k + 1)], up], dim=1))
        x = self.output_conv(x)
        if self.output_activation == "tanh":
            x = torch.tanh(x)
        elif self.output_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 1)
