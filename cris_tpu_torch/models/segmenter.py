"""CRIS segmenter: CLIP encoders -> FPN neck -> VL decoder -> Projector
(counterpart of cris_tpu/models/segmenter.py:26-120, eval forward).

Inputs are NCHW images and (B, L) token ids; the key-padding mask is
``word == 0``. Returns (B, 1, H/4, W/4) mask logits.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .clip import CLIP, CLIPConfig
from .decoder import TransformerDecoder
from .neck import FPN
from .projector import Projector


class CRIS(nn.Module):
    def __init__(self, clip_config: CLIPConfig,
                 fpn_in: Sequence[int] = (512, 1024, 1024),
                 fpn_out: Sequence[int] = (256, 512, 1024),
                 vis_dim: int = 512, num_layers: int = 3, num_head: int = 8,
                 dim_ffn: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.backbone = CLIP(clip_config)
        self.neck = FPN(clip_config.embed_dim, fpn_in, fpn_out)
        self.decoder = TransformerDecoder(num_layers, vis_dim, num_head,
                                          dim_ffn, dropout)
        self.proj = Projector(clip_config.embed_dim, vis_dim // 2, 3)

    def forward(self, img: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        pad_mask = word == 0
        vis = self.backbone.encode_image(img)
        word_feats, state = self.backbone.encode_text(word)
        fq = self.neck(vis, state)
        fq = self.decoder(fq, word_feats, pad_mask)
        return self.proj(fq, state)
