"""FPN multimodal fusion neck (counterpart of cris_tpu/models/neck.py:26-114).
With ``fold_bn`` every conv/linear + BN pair is folded; ``norm_layer``'s BN
normalises a product of features, has nothing to fold into, and stays.

``fuse_upsample`` folds the two bilinear upsamples into the 1x1 convs
over the concatenations that take them (f2_cat, aggr:
``layers.CatUpConvBNReLU``, the JAX package's bf16 rewrite); without it
the upsamples and concatenations run as they are. The int8 sites
(neck.py:40-100): the up-cores of the two folds (family "upfold") and the
"head" convs f1_v_proj, f2_v_proj, f3_v_proj, f3_cat, f4_proj5/4/3 and
the CoordConv block's two."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.resize import avg_pool2d
from .layers import (BatchNorm, CatUpConvBNReLU, ConvBNReLU, CoordConv,
                     LinearBNReLU)


class FPN(nn.Module):
    def __init__(self, state_dim: int,
                 in_channels: Sequence[int] = (512, 1024, 1024),
                 out_channels: Sequence[int] = (256, 512, 1024),
                 fold_bn: bool = False, fuse_upsample: bool = False):
        super().__init__()
        in0, in1, in2 = in_channels
        out0, out1, out2 = out_channels
        f = dict(fold_bn=fold_bn)
        h = dict(fold_bn=fold_bn, family="head")
        up = dict(fold_bn=fold_bn, fuse=fuse_upsample)
        self.txt_proj = LinearBNReLU(state_dim, out2, **f)
        self.f1_v_proj = ConvBNReLU(in2, out2, 1, 0, **h)
        self.norm_layer = nn.Sequential(BatchNorm(out2), nn.ReLU(inplace=True))
        self.f2_v_proj = ConvBNReLU(in1, out1, 3, 1, **h)
        self.f2_cat = CatUpConvBNReLU(out2 + out1, out1, **up)
        self.f3_v_proj = ConvBNReLU(in0, out0, 3, 1, **h)
        self.f3_cat = ConvBNReLU(out0 + out1, out1, 1, 0, **h)
        self.f4_proj5 = ConvBNReLU(out2, out1, 3, 1, **h)
        self.f4_proj4 = ConvBNReLU(out1, out1, 3, 1, **h)
        self.f4_proj3 = ConvBNReLU(out1, out1, 3, 1, **h)
        self.aggr = CatUpConvBNReLU(3 * out1, out1, **up)
        self.coordconv = nn.Sequential(CoordConv(out1, out1, 3, 1, **h),
                                       ConvBNReLU(out1, out1, 3, 1, **h))

    def forward(self, imgs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                state: torch.Tensor) -> torch.Tensor:
        v3, v4, v5 = imgs
        # fusion 1: gate v5 with the projected sentence state
        state = self.txt_proj(state)
        f5 = self.f1_v_proj(v5) * state[:, :, None, None]
        f5 = self.norm_layer(f5)
        # fusion 2: v4 + upsampled f5
        f4 = self.f2_cat([self.f2_v_proj(v4)], f5)
        # fusion 3: pooled v3 + f4
        f3 = avg_pool2d(self.f3_v_proj(v3), 2, 2)
        f3 = self.f3_cat(torch.cat([f3, f4], 1))
        # fusion 4: project the three levels and aggregate at f4's grid
        fq = self.aggr([self.f4_proj3(f3), self.f4_proj4(f4)],
                       self.f4_proj5(f5))
        return self.coordconv(fq)
