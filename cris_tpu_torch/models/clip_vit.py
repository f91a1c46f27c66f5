"""CLIP's ViT image tower, the dense variant (counterpart of
cris_tpu/models/clip_vit.py:23-77), under OpenAI CLIP's names: ``conv1``
(no bias), ``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.N.*``, ``ln_post`` and ``proj``.

The patchify conv (stride = patch), the CLS token, the positional
embedding and ``ln_pre``; then the text encoder's pre-LN blocks
(``clip_text.Transformer``) with no mask, so each block's attention
takes K1 (``ops.attention.dot_product_attention``) as the JAX blocks
take ``fused_attention_bse``; then ``ln_post`` on the patch tokens with
CLS dropped and an f32 ``@ proj``, cast back to the compute dtype.
Images (B, 3, R, R) in, patch features (B, (R / patch)^2, output_dim)
out.
"""

from __future__ import annotations

import torch
from torch import nn

from .clip_text import Transformer
from .layers import LayerNormF32


class VisionTransformer(nn.Module):
    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int):
        super().__init__()
        grid = input_resolution // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 1:])
        with torch.autocast(x.device.type, enabled=False):
            y = x.float() @ self.proj.float()
        return y.to(x.dtype)
