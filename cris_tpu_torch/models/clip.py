"""CLIP dual encoder and architecture presets (counterpart of
cris_tpu/models/clip.py:25-170). Parameter names follow OpenAI CLIP:
``visual.*`` for the image tower and the text tower at the top level."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from .clip_resnet import ModifiedResNet
from .clip_text import Transformer, encode_text
from .layers import LayerNormF32


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Tuple[int, int, int, int]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def vision_heads(self) -> int:
        return self.vision_width * 32 // 64


# Published OpenAI CLIP ResNet architectures used by the CRIS configs, and
# a small one for tests (full CLIP vocabulary, no released weights).
CLIP_PRESETS = {
    "RN50": CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 77, 49408, 512, 8, 12),
    "RN101": CLIPConfig(512, 224, (3, 4, 23, 3), 64, None, 77, 49408, 512, 8, 12),
    "TINY": CLIPConfig(64, 64, (1, 1, 1, 1), 16, None, 77, 49408, 64, 4, 2),
}


def preset_from_name(name: str) -> CLIPConfig:
    """Resolve a preset from a checkpoint path like 'pretrain/RN50.pt'."""
    base = name.rsplit("/", 1)[-1].split(".")[0].upper()
    if base in CLIP_PRESETS:
        return CLIP_PRESETS[base]
    raise KeyError(f"No CLIP preset for {name!r}; known: {sorted(CLIP_PRESETS)}")


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig, fold_bn: bool = False,
                 pos_grid: Optional[int] = None,
                 fused_bottleneck: Union[bool, str] = False,
                 fused_stem: bool = False, rewrites: bool = False):
        super().__init__()
        self.visual = ModifiedResNet(
            layers=cfg.vision_layers,
            output_dim=cfg.embed_dim,
            heads=cfg.vision_heads,
            input_resolution=cfg.image_resolution,
            width=cfg.vision_width,
            fold_bn=fold_bn,
            pos_grid=pos_grid,
            fused_bottleneck=fused_bottleneck,
            fused_stem=fused_stem,
            rewrites=rewrites,
        )
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.transformer_width))
        self.transformer = Transformer(cfg.transformer_width,
                                       cfg.transformer_layers,
                                       cfg.transformer_heads)
        self.ln_final = LayerNormF32(cfg.transformer_width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.transformer_width, cfg.embed_dim))
        # contrastive temperature; CRIS's forward does not use it
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image: torch.Tensor):
        return self.visual(image)

    def encode_text(self, text: torch.Tensor):
        return encode_text(self, text)
