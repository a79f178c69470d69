"""DPT-Large depth net: MiDaS v3.0 ``dpt_large`` (Ranftl, Bochkovskiy and
Koltun, "Vision Transformers for Dense Prediction", ICCV 2021,
arXiv:2103.13413; isl-org/MiDaS ``midas/dpt_depth.py``, ``midas/vit.py``,
``midas/blocks.py``). The JAX package has no transformer depth net; this
one has no counterpart there.

A ViT-L/16 encoder (24 pre-norm blocks of width 1024, 16 heads of 64, MLP
4096, LayerNorm eps 1e-6, exact GELU) over the 16x16 patches of the image
and a class token, its 24x24 pretraining grid of positional embeddings
resized bilinearly (``align_corners=False``) to the image's patch grid.
The outputs of four blocks (``hooks``, before any final norm) are read out
(each patch token concatenated with the class token, Linear 2C -> C,
GELU), laid out as images at 1/16 and reassembled to 1/4, 1/8, 1/16 and
1/32 (1x1 convolutions, transposed convolutions, a strided 3x3); then
MiDaS's fusion decoder and head (``models/midas.py``, in their v3.0 form:
residual units that add ``x``, a 1x1 ``out_conv`` after each fusion, the
head's upsample with aligned corners).

Public layout as ``MidasNet``: images ``[B,H,W,3]`` in [0, 1] (H and W
multiples of 32), normalized with mean 0.5 and deviation 0.5 (the DPT's
transform); depth ``[B,H,W]`` out, ``10000 / clamp(inverse depth, 1e-2)``
(the MiDaS wrapper's conversion, the one departure from the published net).
Attention is ``F.scaled_dot_product_attention``: in float32 on the card
PyTorch's memory-efficient kernel, whose float32 products are 3xTF32, and
in float32 matrix products elsewhere (the train step turns TF32 off).

Keys follow the published checkpoint (``pretrained.model.blocks.0.attn.
qkv``, ``pretrained.act_postprocess1.0.project.0``, ``scratch.refinenet1.
out_conv``, ``scratch.output_conv.4``). It also holds the ViT's final norm
and classifier head and ``scratch.refinenet4.resConfUnit1``, which the
forward never reads; the port builds none of them
(``runtime/weights.py::DPT_LEFTOVERS``). The transpose and unflatten at
``act_postprocess<k>.1`` / ``.2`` hold no weights; here they are
placeholders and ``readout`` does their work.

Under a profiler the forward opens ``dvd/vit`` (the patch embedding and
the blocks) and ``dvd/dpt_head`` (the readouts, reassembly, fusion and
head).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.profiling import annotate
from .blocks import init_module, lecun_normal
from .midas import FeatureFusionBlock, output_head

DPT_MEAN = 0.5
DPT_STD = 0.5
LN_EPS = 1e-6
POS_STD = 0.02  # the class token's and positional embedding's init (timm)


class Attention(nn.Module):
    """``softmax(q k^T / sqrt(d)) v`` over ``heads`` heads of ``dim /
    heads`` (timm ``Attention``)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads,
                                      c // self.heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A pre-norm transformer block (timm ``Block``, no dropout)."""

    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class VisionTransformer(nn.Module):
    """The encoder's weights (``pretrained.model``) and its forward up to
    the last hooked block."""

    def __init__(self, patch: int, dim: int, depth: int, heads: int,
                 mlp: int, grid: int):
        super().__init__()
        self.patch = patch
        self.grid = grid
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp)
                                    for _ in range(depth))

    def pos_embed_at(self, gh: int, gw: int) -> torch.Tensor:
        """The positional embedding on a ``gh x gw`` patch grid: the grid
        part resized bilinearly, the class entry as it is (MiDaS
        ``_resize_pos_embed``)."""
        tok, grid = self.pos_embed[:, :1], self.pos_embed[0, 1:]
        grid = grid.reshape(1, self.grid, self.grid, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                             align_corners=False)
        return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(
            1, gh * gw, -1)], dim=1)

    def forward(self, x, hooks: Sequence[int]):
        """``x [B,3,H,W]`` -> the tokens ``[B,1+N,C]`` after each block of
        ``hooks``."""
        b, _, h, w = x.shape
        pos = self.pos_embed_at(h // self.patch, w // self.patch)
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1) + pos
        outs = []
        for i, blk in enumerate(self.blocks[:max(hooks) + 1]):
            x = blk(x)
            if i in hooks:
                outs.append(x)
        return outs


class ProjectReadout(nn.Module):
    """Each patch token concatenated with the class token, then Linear
    2C -> C and GELU (MiDaS ``ProjectReadout``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        patches = x[:, 1:]
        return self.project(torch.cat(
            [patches, x[:, :1].expand_as(patches)], dim=-1))


def _postprocess(dim: int, out: int, level: int) -> nn.Sequential:
    """``act_postprocess<level>``: readout, two weightless placeholders
    (the original's transpose and unflatten), 1x1 to ``out``, then level 1
    a 4x4 transposed convolution of stride 4, level 2 2x2 of stride 2,
    level 4 a 3x3 convolution of stride 2."""
    layers = [ProjectReadout(dim), nn.Identity(), nn.Identity(),
              nn.Conv2d(dim, out, 1)]
    if level == 1:
        layers.append(nn.ConvTranspose2d(out, out, 4, stride=4))
    elif level == 2:
        layers.append(nn.ConvTranspose2d(out, out, 2, stride=2))
    elif level == 4:
        layers.append(nn.Conv2d(out, out, 3, stride=2, padding=1))
    return nn.Sequential(*layers)


class _Encoder(nn.Module):
    """``pretrained``: the ViT and its four readouts."""

    def __init__(self, patch, dim, depth, heads, mlp, grid, reassemble):
        super().__init__()
        self.model = VisionTransformer(patch, dim, depth, heads, mlp, grid)
        for level, out in enumerate(reassemble, 1):
            setattr(self, f"act_postprocess{level}",
                    _postprocess(dim, out, level))


class _Scratch(nn.Module):
    def __init__(self, reassemble, features: int):
        super().__init__()
        for i, c in enumerate(reassemble, 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        kw = dict(relu_skip=False, out_conv=True)
        self.refinenet4 = FeatureFusionBlock(features, False, **kw)
        self.refinenet3 = FeatureFusionBlock(features, True, **kw)
        self.refinenet2 = FeatureFusionBlock(features, True, **kw)
        self.refinenet1 = FeatureFusionBlock(features, True, **kw)
        self.output_conv = output_head(features, features // 2, nn.ReLU(),
                                       align_corners=True)


class DPTDepthNet(nn.Module):
    """DPT-Large at its published widths by default; every width is an
    argument, so tests can build it small."""

    def __init__(self, patch: int = 16, dim: int = 1024, depth: int = 24,
                 heads: int = 16, mlp: int = 4096,
                 hooks: Sequence[int] = (5, 11, 17, 23), grid: int = 24,
                 reassemble: Sequence[int] = (256, 512, 1024, 1024),
                 features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(hooks) != 4 or len(reassemble) != 4:
            raise ValueError("the DPT reads four blocks into four levels")
        self.hooks = tuple(hooks)
        self.pretrained = _Encoder(patch, dim, depth, heads, mlp, grid,
                                   reassemble)
        self.scratch = _Scratch(reassemble, features)
        init_module(self, lecun_normal(), generator)
        vit = self.pretrained.model
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.ConvTranspose2d):
                    # fan-in of a transposed convolution: its input channels
                    m.weight.normal_(0.0, m.in_channels ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
            for p in (vit.cls_token, vit.pos_embed):
                p.normal_(0.0, POS_STD, generator=generator)

    def readout(self, level: int, tokens: torch.Tensor, gh: int,
                gw: int) -> torch.Tensor:
        """Hooked tokens -> the reassembled image of ``level``."""
        post = getattr(self.pretrained, f"act_postprocess{level}")
        x = post[0](tokens).transpose(1, 2)
        return post[3:](x.unflatten(2, (gh, gw)))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = ((img - DPT_MEAN) / DPT_STD).permute(0, 3, 1, 2)
        patch = self.pretrained.model.patch
        gh, gw = x.shape[2] // patch, x.shape[3] // patch
        with annotate("dvd/vit"):
            tokens = self.pretrained.model(x, self.hooks)
        with annotate("dvd/dpt_head"):
            s = self.scratch
            l1, l2, l3, l4 = (
                getattr(s, f"layer{i}_rn")(self.readout(i, t, gh, gw))
                for i, t in enumerate(tokens, 1))
            path = s.refinenet4(l4)
            path = s.refinenet3(path, l3)
            path = s.refinenet2(path, l2)
            path = s.refinenet1(path, l1)
            out = 10000.0 / torch.clamp(s.output_conv(path), min=1e-2)
        return out[:, 0]
