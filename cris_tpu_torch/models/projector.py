"""Text-to-pixel projector (counterpart of cris_tpu/models/projector.py):
upsampling trunk 26 -> 52 -> 104 and a per-sample 3x3 dynamic conv whose
kernel and bias one Linear generates from the sentence state."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.dynamic_conv import dynamic_conv2d
from .layers import ConvBNReLU, Upsample2x


class Projector(nn.Module):
    def __init__(self, word_dim: int = 1024, in_dim: int = 256,
                 kernel_size: int = 3, fold_bn: bool = False):
        super().__init__()
        self.in_dim = in_dim
        self.kernel_size = kernel_size
        self.vis = nn.Sequential(
            Upsample2x(),
            ConvBNReLU(in_dim * 2, in_dim * 2, 3, 1, fold_bn=fold_bn),
            Upsample2x(),
            ConvBNReLU(in_dim * 2, in_dim, 3, 1, fold_bn=fold_bn),
            nn.Conv2d(in_dim, in_dim, 1),
        )
        self.txt = nn.Linear(word_dim, in_dim * kernel_size * kernel_size + 1)

    def forward(self, x: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        """x (B, 2*in_dim, 26, 26), word (B, word_dim) -> (B, 1, 104, 104)."""
        x = self.vis(x)
        k = self.kernel_size
        params = self.txt(word)
        weight = params[:, :-1].reshape(x.shape[0], self.in_dim, k, k)
        return dynamic_conv2d(x, weight, params[:, -1], k)
