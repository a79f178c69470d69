"""Plain reference of DPT-Large, MiDaS v3.0 ``dpt_large`` (Ranftl,
Bochkovskiy and Koltun, ICCV 2021, arXiv:2103.13413; isl-org/MiDaS
``midas/dpt_depth.py``, ``midas/vit.py``, ``midas/blocks.py``), in float32
NCHW ``torch.nn`` layers, sized by ``dpt_large.json``.

Images ``[B,H,W,3]`` in [0, 1] are normalized with mean 0.5 and deviation
0.5. A ViT (patch embedding, class token, positional embedding whose
pretraining grid is resized bilinearly without aligned corners to the
image's patch grid, pre-norm blocks with LayerNorm eps 1e-6, attention as
an explicit ``softmax(q k^T / sqrt(d)) v``, exact GELU) gives the tokens
after the hooked blocks; each is read out (patch tokens concatenated with
the class token, Linear, GELU), laid out at 1/16 and reassembled; then the
fusion blocks (residual units that add ``x``, bilinear 2x with aligned
corners, a 1x1 ``out_conv``; the one-input block has no first unit) and
the head (3x3 to half the features, bilinear 2x with aligned corners, 3x3
to 32, ReLU, 1x1 to 1, ReLU). The depth ``[B,H,W]`` is ``10000 / clamp(
inverse depth, 1e-2)``, the MiDaS wrapper's conversion. Parameter names
are the published checkpoint's (``pretrained.model.blocks.0.attn.qkv.
weight``, ``scratch.output_conv.4.bias``); the ViT's final norm and
classifier head, which the forward never reads, are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class ViT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim, grid = cfg["hidden_size"], cfg["pretrain_grid"]
        self.patch_embed = PatchEmbed(cfg["patch_size"], dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, cfg["num_heads"], cfg["mlp_size"], cfg["ln_eps"])
            for _ in range(cfg["num_layers"]))


class Readout(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())


def postprocess(dim, out, level):
    """Readout, two weightless steps (transpose, unflatten), 1x1 conv, then
    the level's resampling."""
    layers = [Readout(dim), nn.Identity(), nn.Identity(),
              nn.Conv2d(dim, out, 1)]
    if level == 1:
        layers.append(nn.ConvTranspose2d(out, out, 4, stride=4))
    elif level == 2:
        layers.append(nn.ConvTranspose2d(out, out, 2, stride=2))
    elif level == 4:
        layers.append(nn.Conv2d(out, out, 3, stride=2, padding=1))
    return nn.Sequential(*layers)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.model = ViT(cfg)
        for level, out in enumerate(cfg["reassemble"], 1):
            setattr(self, f"act_postprocess{level}",
                    postprocess(cfg["hidden_size"], out, level))


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, features, two_inputs):
        super().__init__()
        if two_inputs:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, *xs):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = F.interpolate(self.resConfUnit2(out), scale_factor=2,
                            mode="bilinear", align_corners=True)
        return self.out_conv(out)


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=True)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        f = cfg["features"]
        for i, c in enumerate(cfg["reassemble"], 1):
            setattr(self, f"layer{i}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
        self.refinenet4 = FusionBlock(f, False)
        self.refinenet3 = FusionBlock(f, True)
        self.refinenet2 = FusionBlock(f, True)
        self.refinenet1 = FusionBlock(f, True)
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), Upsample(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class DPT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.patch = cfg["patch_size"]
        self.grid = cfg["pretrain_grid"]
        self.hooks = list(cfg["hooks"])
        self.pretrained = Encoder(cfg)
        self.scratch = Decoder(cfg)

    def tokens(self, x):
        vit = self.pretrained.model
        b, _, h, w = x.shape
        gh, gw = h // self.patch, w // self.patch
        grid = vit.pos_embed[0, 1:].reshape(1, self.grid, self.grid, -1)
        grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(gh, gw),
                             mode="bilinear", align_corners=False)
        pos = torch.cat([vit.pos_embed[:, :1], grid.permute(0, 2, 3, 1)
                         .reshape(1, gh * gw, -1)], dim=1)
        x = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([vit.cls_token.expand(b, -1, -1), x], dim=1) + pos
        outs = []
        for i, blk in enumerate(vit.blocks):
            x = blk(x)
            if i in self.hooks:
                outs.append(x)
        return outs, gh, gw

    def forward(self, img):
        x = ((img - 0.5) / 0.5).permute(0, 3, 1, 2)
        tokens, gh, gw = self.tokens(x)
        s = self.scratch
        levels = []
        for level, t in enumerate(tokens, 1):
            post = getattr(self.pretrained, f"act_postprocess{level}")
            patches = t[:, 1:]
            r = post[0].project(torch.cat(
                [patches, t[:, :1].expand_as(patches)], dim=-1))
            r = r.transpose(1, 2).reshape(r.shape[0], -1, gh, gw)
            levels.append(getattr(s, f"layer{level}_rn")(post[3:](r)))
        path = s.refinenet4(levels[3])
        path = s.refinenet3(path, levels[2])
        path = s.refinenet2(path, levels[1])
        path = s.refinenet1(path, levels[0])
        out = 10000.0 / torch.clamp(s.output_conv(path), min=1e-2)
        return out[:, 0]


def build(cfg) -> nn.Module:
    return DPT(cfg)
