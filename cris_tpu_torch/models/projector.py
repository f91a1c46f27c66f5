"""Text-to-pixel projector (counterpart of cris_tpu/models/projector.py):
upsampling trunk 26 -> 52 -> 104 and a per-sample 3x3 dynamic conv whose
kernel and bias one Linear generates from the sentence state.

``fuse_upsample`` folds the trunk's two upsamples into the 3x3 convs
after them (``layers.UpConvBNReLU``, the JAX package's bf16 rewrite);
the keys stay CRIS.pytorch's (``vis.1``, ``vis.3``, ``vis.4``). The int8
sites (projector.py:49-85): the two folds' up-cores (family "upfold")
and ``vis_out`` (``vis.4``, family "head")."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.dynamic_conv import dynamic_conv2d
from .layers import QuantConv, UpConvBNReLU, Upsample2x


class Projector(nn.Module):
    def __init__(self, word_dim: int = 1024, in_dim: int = 256,
                 kernel_size: int = 3, fold_bn: bool = False,
                 fuse_upsample: bool = False):
        super().__init__()
        self.in_dim = in_dim
        self.kernel_size = kernel_size
        # the upsamples are parts of the UpConvBNReLUs; these hold the keys
        up = dict(fold_bn=fold_bn, fuse=fuse_upsample)
        self.vis = nn.Sequential(
            Upsample2x(),
            UpConvBNReLU(in_dim * 2, in_dim * 2, **up),
            Upsample2x(),
            UpConvBNReLU(in_dim * 2, in_dim, **up),
            QuantConv(in_dim, in_dim, 1, family="head"),
        )
        self.txt = nn.Linear(word_dim, in_dim * kernel_size * kernel_size + 1)

    def forward(self, x: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        """x (B, 2*in_dim, 26, 26), word (B, word_dim) -> (B, 1, 104, 104)."""
        x = self.vis[4](self.vis[3](self.vis[1](x)))
        k = self.kernel_size
        params = self.txt(word)
        weight = params[:, :-1].reshape(x.shape[0], self.in_dim, k, k)
        return dynamic_conv2d(x, weight, params[:, -1], k)
