"""CRIS segmenter: CLIP encoders -> FPN neck -> VL decoder -> Projector
(counterpart of cris_tpu/models/segmenter.py:26-120).

Inputs are NCHW images and (B, L) token ids; the key-padding mask is
``word == 0``. Returns (B, 1, H/4, W/4) mask logits; given a GT mask, the
mask is nearest-resized to the prediction's grid and the mean binary
cross entropy with logits (f32) comes back with the prediction and the
resized mask, as in training.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize2d
from .clip import CLIP, CLIPConfig
from .decoder import TransformerDecoder
from .neck import FPN
from .projector import Projector


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy with logits in f32, in the stable form
    max(x, 0) - x z + log1p(exp(-|x|)) (segmenter.py:26-34)."""
    with torch.autocast(logits.device.type, enabled=False):
        x = logits.float()
        z = labels.float()
        loss = F.relu(x) - x * z + torch.log1p(torch.exp(-x.abs()))
        return loss.mean()


class CRIS(nn.Module):
    # CLIP's contrastive temperature, which CRIS's loss never reaches: its
    # gradient is the zeros that ``apply_gradients`` fills in, and data
    # parallel leaves it out of the gradient all-reduce
    unreached_params = ("backbone.logit_scale",)

    def __init__(self, clip_config: CLIPConfig,
                 fpn_in: Sequence[int] = (512, 1024, 1024),
                 fpn_out: Sequence[int] = (256, 512, 1024),
                 vis_dim: int = 512, num_layers: int = 3, num_head: int = 8,
                 dim_ffn: int = 2048, dropout: float = 0.1,
                 fold_bn: bool = False, pos_grid: Optional[int] = None,
                 fused_bottleneck: Union[bool, str] = False,
                 fused_stem: bool = False, rewrites: bool = False):
        """``fold_bn``, ``pos_grid``, the two kernel switches and
        ``rewrites``: see ``models.build_segmenter``."""
        super().__init__()
        self.backbone = CLIP(clip_config, fold_bn=fold_bn, pos_grid=pos_grid,
                             fused_bottleneck=fused_bottleneck,
                             fused_stem=fused_stem, rewrites=rewrites)
        self.neck = FPN(clip_config.embed_dim, fpn_in, fpn_out, fold_bn,
                        fuse_upsample=rewrites)
        self.decoder = TransformerDecoder(num_layers, vis_dim, num_head,
                                          dim_ffn, dropout)
        self.proj = Projector(clip_config.embed_dim, vis_dim // 2, 3, fold_bn,
                              fuse_upsample=rewrites)

    def forward(self, img: torch.Tensor, word: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None):
        """img (B, 3, H, W), word (B, L) ids, mask (B, 1, H, W) in [0, 1].
        Returns the logits, or (logits, resized mask, loss) given a mask.
        ``dropout_seed`` seeds the decoder's dropout in training."""
        pad_mask = word == 0
        vis = self.backbone.encode_image(img)
        word_feats, state = self.backbone.encode_text(word)
        fq = self.neck(vis, state)
        fq = self.decoder(fq, word_feats, pad_mask, dropout_seed)
        pred = self.proj(fq, state)
        if mask is None:
            return pred
        mask = resize2d(mask, pred.shape[-2:], "nearest")
        return pred, mask, bce_with_logits(pred, mask)
