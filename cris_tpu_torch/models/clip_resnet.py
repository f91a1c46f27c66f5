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

``rewrites`` turns on two of the JAX package's exact bf16 graph rewrites
(``_auto_fuse_pool``, ``_auto_s2d``, clip_resnet.py:33-57): the
anti-aliasing average pools fused into the 1x1 convs after them
(``QuantConv.pooled``: a strided block's conv3 and downsample, and
layer1_0's conv1 and downsample, which take the stem's pool), and the
space-to-depth stem (ops/s2d.py: conv1 writes the s2d layout, conv2 and
conv3 stay in it, layer1_0's pooled convs leave it, ``s2d_pooled``).
The s2d stem needs H, W % 4 == 0; K7 keeps priority over it, as
``use_pallas_stem`` does. The JAX package's opt-in tier 2
(``CRIS_S2D_L1``, layer1 s2d-resident) is not ported. On a model given a
``QuantConfig`` (``layers.enable_int8``) the bottlenecks' convs are int8
sites of family "backbone" and the s2d stem's conv2 and conv3 of family
"stem" (clip_resnet.py:129-160, 380-440).
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
from ..ops.s2d import stem_conv1_s2d
from .layers import QuantConv, norm, remat


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
    K5 here and XLA in the JAX package.

    ``fuse_pool``: the stride's pools are fused into conv3 and the
    downsample conv (``QuantConv.pooled``). ``forward``'s ``entry`` is
    layer1_0's input when the stem's pool is fused too: "pool" (conv1 and
    the downsample pool by 2) or "s2d" (the input is the s2d stem's,
    conv1 and the downsample are ``s2d_pooled``).

    ``remat`` (set by ``build_segmenter`` from ``cfg.remat``): in training
    with gradients on, the block's activations are recomputed in the
    backward (cris_tpu/models/clip_resnet.py:451, 475-476)."""

    expansion = 4
    remat = False

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fold_bn: bool = False, fused: Optional[str] = None,
                 fuse_pool: bool = False):
        super().__init__()
        out_planes = planes * self.expansion
        identity = stride == 1 and inplanes == out_planes
        if fused and not (fold_bn and identity):
            raise ValueError("K5 runs only BN-folded stride-1 identity blocks")
        if fused and fused not in TAIL_RULES:
            raise ValueError(f"unknown K5 tail rule {fused!r}")
        self.fused = fused
        self.stride = stride
        self.fuse_pool = fuse_pool
        conv = dict(bias=fold_bn, family="backbone")
        self.conv1 = QuantConv(inplanes, planes, 1, **conv)
        self.bn1 = norm(planes, fold_bn)
        self.conv2 = QuantConv(planes, planes, 3, padding=1, **conv)
        self.bn2 = norm(planes, fold_bn)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = QuantConv(planes, out_planes, 1, **conv)
        self.bn3 = norm(out_planes, fold_bn)
        self.downsample = None
        if not identity:
            # CLIP names the pool "-1" so the conv and BN keep keys 0 and 1
            self.downsample = nn.Sequential()
            self.downsample.add_module(
                "-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity())
            self.downsample.add_module(
                "0", QuantConv(inplanes, out_planes, 1, **conv))
            self.downsample.add_module("1", norm(out_planes, fold_bn))

    def forward(self, x: torch.Tensor,
                entry: Optional[str] = None) -> torch.Tensor:
        if self.fused and entry is None and bottleneck_takes(
                x.shape[2], x.shape[3], x.shape[1], self.conv1.out_channels,
                compute_dtype(x), self.fused):
            _no_training(self, "fused_bottleneck (K5)")
            w1, w2, w3 = (_hwio(c) for c in (self.conv1, self.conv2, self.conv3))
            return _nchw(fused_bottleneck(
                _nhwc(x), w1[0, 0], self.conv1.bias,
                w2.reshape(9, *w2.shape[2:]), self.conv2.bias,
                w3[0, 0], self.conv3.bias))
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self._chain, x, entry)
        return self._chain(x, entry)

    def _entry_conv(self, conv: QuantConv, x, entry, pool: int = 1):
        if entry == "s2d":
            return conv.s2d_pooled(x)
        if entry == "pool":
            pool = max(pool, 2)
        return conv.pooled(x, pool) if pool > 1 else conv(x)

    def _chain(self, x: torch.Tensor, entry: Optional[str] = None
               ) -> torch.Tensor:
        out = F.relu(self.bn1(self._entry_conv(self.conv1, x, entry)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.fuse_pool and self.stride > 1:
            out = self.bn3(self.conv3.pooled(out, self.stride))
        else:
            out = self.bn3(self.conv3(self.avgpool(out)))
        if self.downsample is None:
            identity = x
        elif self.fuse_pool:
            # keys "0" and "1" (positions 1 and 2: "-1" is the pool)
            ds = self.downsample._modules
            identity = ds["1"](self._entry_conv(ds["0"], x, entry,
                                                self.stride))
        else:
            identity = self.downsample(x)
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
    simply takes the place of stem + pool and layer1 follows unchanged.
    ``rewrites``: the fused pools and the s2d stem (module docstring)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 fold_bn: bool = False, pos_grid: Optional[int] = None,
                 fused_bottleneck: Union[bool, str] = False,
                 fused_stem: bool = False, rewrites: bool = False):
        super().__init__()
        if (fused_bottleneck or fused_stem) and not fold_bn:
            raise ValueError("K5 and K7 run only on the BN-folded model")
        self.fused_stem = fused_stem
        self.rewrites = rewrites
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1,
                               bias=fold_bn)
        self.bn1 = norm(width // 2, fold_bn)
        self.conv2 = QuantConv(width // 2, width // 2, 3, padding=1,
                               bias=fold_bn, family="stem")
        self.bn2 = norm(width // 2, fold_bn)
        self.conv3 = QuantConv(width // 2, width, 3, padding=1, bias=fold_bn,
                               family="stem")
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
        mods = [Bottleneck(self._inplanes, planes, stride, self._fold_bn,
                           fuse_pool=self.rewrites)]
        self._inplanes = planes * Bottleneck.expansion
        mods += [Bottleneck(self._inplanes, planes, 1, self._fold_bn,
                            fused=self._fuse_tails, fuse_pool=self.rewrites)
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def stem(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[str]]:
        """Three 3x3 convs with ReLUs, then the 2x2 average pool; returns
        the map and how layer1_0 enters it (``Bottleneck.forward``'s
        ``entry``): with ``rewrites`` the pool is left to layer1_0, and at
        H, W % 4 == 0 the stem runs in s2d layout."""
        by4 = x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0
        if self.fused_stem and by4:
            _no_training(self, "fused_stem_pool (K7)")
            dt = compute_dtype(x)
            k1, k2, k3 = (_hwio(c).to(dt)
                          for c in (self.conv1, self.conv2, self.conv3))
            return _nchw(fused_stem_pool(
                _nhwc(x), k1, self.conv1.bias, k2, self.conv2.bias, k3,
                self.conv3.bias)), None
        if self.rewrites and by4:
            y = _nchw(stem_conv1_s2d(_nhwc(x), _hwio(self.conv1),
                                     self.conv1.bias, compute_dtype(x)))
            y = F.relu(_bn_s2d(self.bn1, y))
            y = F.relu(_bn_s2d(self.bn2, self.conv2.s2d3x3(y)))
            return F.relu(_bn_s2d(self.bn3, self.conv3.s2d3x3(y))), "s2d"
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        if self.rewrites:
            return x, "pool"
        return self.avgpool(x), None

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, entry = self.stem(x)
        x = self.layer1[1:](self.layer1[0](x, entry))
        x2 = self.layer2(x)
        x3 = self.layer3(x2)
        x4 = self.attnpool(self.layer4(x3))
        return x2, x3, x4


def _bn_s2d(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The BN of the original channels on an s2d tensor (B, 4C, H, W):
    each original pixel appears once, so the statistics are the plain
    layout's (the JAX BatchNorm's ``phases=4``)."""
    if isinstance(bn, nn.Identity):
        return x
    b, c4, h, w = x.shape
    return bn(x.reshape(b * 4, c4 // 4, h, w)).reshape(b, c4, h, w)
