"""CLIP's ModifiedResNet image encoder, NCHW, in CRIS's dense form.

Counterpart of cris_tpu/models/clip_resnet.py:63-261 (Bottleneck),
263-323 (AttentionPool2d) and 326-525 (ModifiedResNet), in its plain f32
formulation: standalone anti-aliasing average pools and the reference op
order. The forward returns the layer2 and layer3 maps and the
attention-pooled layer4 map, ``(v3, v4, v5)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.resize import resize2d
from .layers import BatchNorm


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> [avg pool] -> 1x1 with CLIP's anti-aliased stride:
    the stride is an average pool after the 3x3, and in the shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm(out_planes)
        self.downsample = None
        if stride > 1 or inplanes != out_planes:
            # CLIP names the pool "-1" so the conv and BN keep keys 0 and 1
            self.downsample = nn.Sequential()
            self.downsample.add_module(
                "-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity())
            self.downsample.add_module(
                "0", nn.Conv2d(inplanes, out_planes, 1, bias=False))
            self.downsample.add_module("1", BatchNorm(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Self-attention over the layer4 grid with the learned positional
    embedding resized (bicubic) to the actual grid, q/k/v/c projections,
    K1 for the attention, and a 1x1 conv + BN residual (``connect``)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.connect = nn.Sequential(
            nn.Conv2d(embed_dim, output_dim, 1, bias=False),
            BatchNorm(output_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        res = self.connect(x)
        pos = self.positional_embedding
        sd = int(round((pos.shape[0] - 1) ** 0.5))
        grid = pos[1:].reshape(1, sd, sd, c).permute(0, 3, 1, 2)
        grid = resize2d(grid, (h, w), "bicubic", align_corners=False)
        grid = grid.reshape(c, h * w).t()
        tokens = x.flatten(2).transpose(1, 2) + grid.to(x.dtype)
        q = self.q_proj(tokens)
        k = self.k_proj(tokens)
        v = self.v_proj(tokens)
        out = self.c_proj(dot_product_attention(q, k, v, self.num_heads))
        out = out.transpose(1, 2).reshape(b, -1, h, w)
        return F.relu(out + res)


class ModifiedResNet(nn.Module):
    """3-conv stem + 2x2 avg pool, four bottleneck stages, attnpool."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(width)
        self.avgpool = nn.AvgPool2d(2)
        self._inplanes = width
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def _make_layer(self, planes: int, blocks: int, stride: int = 1):
        mods = [Bottleneck(self._inplanes, planes, stride)]
        self._inplanes = planes * Bottleneck.expansion
        mods += [Bottleneck(self._inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        x = self.layer1(x)
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.attnpool(self.layer4(x3))
        return x2, x3, x4
