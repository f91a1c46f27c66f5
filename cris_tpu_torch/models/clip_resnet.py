"""CLIP's ModifiedResNet image encoder, NCHW, in CRIS's dense form.

Counterpart of cris_tpu/models/clip_resnet.py:63-261 (Bottleneck),
263-323 (AttentionPool2d) and 326-525 (ModifiedResNet), in its plain f32
formulation: standalone anti-aliasing average pools and the reference op
order. The forward returns the layer2 and layer3 maps and the
attention-pooled layer4 map, ``(v3, v4, v5)``.

``fold_bn`` builds the inference variant whose convs carry the folded BN
(``checkpoint.fold.fold_batchnorm``). On it two kernels can run, each
behind its own switch, off by default as the JAX package's
``CRIS_PALLAS_BOTTLENECK`` and ``CRIS_PALLAS_STEM`` are:
``fused_bottleneck`` sends the stride-1 identity bottlenecks (the stage
tails) that K5's tail gate takes through K5, ``fused_stem`` sends the
stem and its pool through K7.
Both kernels take NHWC views of the model's NCHW tensors and write NCHW
memory, so nothing is transposed around them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.kernels.bottleneck import (K5_TAILS, TAIL_RULES, bottleneck_takes,
                                     compute_dtype, fused_bottleneck)
from ..ops.kernels.stem import fused_stem_pool
from ..ops.resize import resize2d
from .layers import norm


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """(O, I, kh, kw) -> (kh, kw, I, O), the JAX kernels' layout."""
    return conv.weight.permute(2, 3, 1, 0)


def _no_training(module: nn.Module, kernel: str) -> None:
    if module.training:
        raise RuntimeError(f"{kernel} is an inference kernel of the folded "
                           "model; call .eval() first")


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> [avg pool] -> 1x1 with CLIP's anti-aliased stride:
    the stride is an average pool after the 3x3, and in the shortcut.

    ``fused``: a K5 tail rule (``TAIL_RULES``), or None: run the block as
    K5 wherever ``bottleneck_takes`` takes its shape under that rule, and
    as the cuDNN chain elsewhere (needs ``fold_bn``, stride 1 and
    ``inplanes == planes * 4``; set on exactly those blocks). Unlike the
    JAX gate (``supports_shape``: channels multiples of 128, a VMEM fit)
    the rule "every" takes every such block, so layer1's mid-64 tails run
    K5 here and XLA in the JAX package."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False, fused: Optional[str] = None):
        super().__init__()
        out_planes = planes * self.expansion
        identity = stride == 1 and inplanes == out_planes
        if fused and not (fold_bn and identity):
            raise ValueError("K5 runs only BN-folded stride-1 identity blocks")
        if fused and fused not in TAIL_RULES:
            raise ValueError(f"unknown K5 tail rule {fused!r}")
        self.fused = fused
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=fold_bn)
        self.bn1 = norm(planes, fold_bn)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=fold_bn)
        self.bn2 = norm(planes, fold_bn)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=fold_bn)
        self.bn3 = norm(out_planes, fold_bn)
        self.downsample = None
        if not identity:
            # CLIP names the pool "-1" so the conv and BN keep keys 0 and 1
            self.downsample = nn.Sequential()
            self.downsample.add_module(
                "-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity())
            self.downsample.add_module(
                "0", nn.Conv2d(inplanes, out_planes, 1, bias=fold_bn))
            self.downsample.add_module("1", norm(out_planes, fold_bn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and bottleneck_takes(
                x.shape[2], x.shape[3], x.shape[1], self.conv1.out_channels,
                compute_dtype(x), self.fused):
            _no_training(self, "fused_bottleneck (K5)")
            w1, w2, w3 = (_hwio(c) for c in (self.conv1, self.conv2, self.conv3))
            return _nchw(fused_bottleneck(
                _nhwc(x), w1[0, 0], self.conv1.bias,
                w2.reshape(9, *w2.shape[2:]), self.conv2.bias,
                w3[0, 0], self.conv3.bias))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Self-attention over the layer4 grid with the learned positional
    embedding resized (bicubic) to the actual grid, q/k/v/c projections,
    K1 for the attention, and a 1x1 conv + BN residual (``connect``).

    ``pos_grid`` declares the embedding at that grid, for weights whose
    embedding ``fold_batchnorm(input_resolution=...)`` pre-resized; the
    resize is then a no-op at that input size."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, fold_bn: bool = False,
                 pos_grid: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty((pos_grid or spacial_dim) ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.connect = nn.Sequential(
            nn.Conv2d(embed_dim, output_dim, 1, bias=fold_bn),
            norm(output_dim, fold_bn),
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
    """3-conv stem + 2x2 avg pool, four bottleneck stages, attnpool.

    ``fused_bottleneck``: False, True (K5's default tail rule,
    ``K5_TAILS``) or a tail rule name: the rule the stage tails run K5 by.
    ``fused_stem``: run the stem and its pool as K7 (needs ``fold_bn``)
    whenever H and W are multiples of 4. The JAX model also asks for its
    fused pools and H, W % 16 (its kernel's row blocks); here K7's output
    simply takes the place of stem + pool and layer1 follows unchanged."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 fold_bn: bool = False, pos_grid: Optional[int] = None,
                 fused_bottleneck: Union[bool, str] = False,
                 fused_stem: bool = False):
        super().__init__()
        if (fused_bottleneck or fused_stem) and not fold_bn:
            raise ValueError("K5 and K7 run only on the BN-folded model")
        self.fused_stem = fused_stem
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1,
                               bias=fold_bn)
        self.bn1 = norm(width // 2, fold_bn)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1,
                               bias=fold_bn)
        self.bn2 = norm(width // 2, fold_bn)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=fold_bn)
        self.bn3 = norm(width, fold_bn)
        self.avgpool = nn.AvgPool2d(2)
        self._inplanes = width
        self._fold_bn = fold_bn
        self._fuse_tails = (K5_TAILS if fused_bottleneck is True
                            else fused_bottleneck or None)
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim, fold_bn, pos_grid)

    def _make_layer(self, planes: int, blocks: int, stride: int = 1):
        mods = [Bottleneck(self._inplanes, planes, stride, self._fold_bn)]
        self._inplanes = planes * Bottleneck.expansion
        mods += [Bottleneck(self._inplanes, planes, 1, self._fold_bn,
                            fused=self._fuse_tails) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Three 3x3 convs with ReLUs, then the 2x2 average pool."""
        if self.fused_stem and x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0:
            _no_training(self, "fused_stem_pool (K7)")
            dt = compute_dtype(x)
            k1, k2, k3 = (_hwio(c).to(dt)
                          for c in (self.conv1, self.conv2, self.conv3))
            return _nchw(fused_stem_pool(
                _nhwc(x), k1, self.conv1.bias, k2, self.conv2.bias, k3,
                self.conv3.bias))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        return self.avgpool(x)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.layer1(self.stem(x))
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.attnpool(self.layer4(x3))
        return x2, x3, x4
