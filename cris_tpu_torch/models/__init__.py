"""Model registry and builder (counterpart of cris_tpu/models/__init__.py:33-73).

``build_segmenter(cfg, device, seed)`` builds CRIS from a flat config with
seeded random weights (a ``torch.Generator``), on the card by default, or
with no storage at all on the ``meta`` device; ``fold_bn=True`` builds the
BN-folded inference variant; ``clip_config`` (a CLIP archive's, from
``checkpoint.torch_convert``) takes the place of the preset that
``cfg.clip_pretrain`` names. Weights from the JAX package load through
``cris_tpu_torch.checkpoint.from_jax``. ``param_group_label`` splits the
parameters into the optimizer's backbone and head groups.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from .clip import CLIP, CLIP_PRESETS, CLIPConfig, preset_from_name
from .clip_resnet import AttentionPool2d, Bottleneck, ModifiedResNet
from .clip_text import PackedAttention, ResidualAttentionBlock, Transformer
from .decoder import (MultiheadAttention, TransformerDecoder,
                      TransformerDecoderLayer)
from .layers import (BatchNorm, ConvBNReLU, CoordConv, Dropout, LayerNormF32,
                     LinearBNReLU, quick_gelu)
from .neck import FPN
from .projector import Projector
from .segmenter import CRIS, bce_with_logits

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": None, "float32": None, "f32": None}


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config precision -> autocast dtype (None = plain f32)."""
    key = str(name).lower()
    if key not in _DTYPES:
        raise ValueError(f"unknown or not yet ported precision {name!r}")
    return _DTYPES[key]


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in the JAX package's scheme: weights normal with
    std fan_in**-0.5, biases 0, norms at identity, CLIP's embeddings at
    their own scales. Deterministic for a seed and an architecture."""
    gen = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            normal_(mod.weight, fan_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (MultiheadAttention, PackedAttention)):
            normal_(mod.in_proj_weight, mod.in_proj_weight.shape[1] ** -0.5)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        elif isinstance(mod, AttentionPool2d):
            pos = mod.positional_embedding
            normal_(pos, pos.shape[1] ** -0.5)
        elif isinstance(mod, CLIP):
            normal_(mod.positional_embedding, 0.01)
            normal_(mod.text_projection, mod.text_projection.shape[0] ** -0.5)
            mod.logit_scale.fill_(math.log(1 / 0.07))
    return model


def build_segmenter(cfg, device="cuda", seed: int = 0, train: bool = False,
                    fold_bn: bool = False, pos_grid: Optional[int] = None,
                    fused_bottleneck: Union[bool, str] = False,
                    fused_stem: bool = False,
                    clip_config: Optional[CLIPConfig] = None) -> CRIS:
    """CRIS from a flat config (see config/*/*.yaml), in eval mode, or in
    train mode (batch-statistics BN, dropout) with ``train=True``, on the
    card unless ``device`` says otherwise. The CLIP architecture is
    ``clip_config``, else the preset ``cfg.clip_pretrain`` names.
    ``cfg.remat`` (cris_tpu/models/__init__.py:66) recomputes each
    backbone bottleneck, text block and decoder layer in the backward;
    it acts in training only.

    ``fold_bn`` builds the inference variant for weights that
    ``checkpoint.fold_batchnorm`` folded (convs with biases, no BN but the
    neck's ``norm_layer``); ``pos_grid`` declares the attnpool embedding
    at that grid (``fold_batchnorm(input_resolution=...)``). The kernel
    switches, the JAX package's ``CRIS_PALLAS_BOTTLENECK`` and
    ``CRIS_PALLAS_STEM``, default off as those do: ``fused_bottleneck``
    runs the stride-1 identity bottlenecks that K5's tail gate takes as K5
    (True: under its default rule ``K5_TAILS``; a rule name of
    ``ops.kernels.bottleneck.TAIL_RULES``: under that rule), ``fused_stem``
    the stem and its pool as K7. Both need ``fold_bn`` and eval.

    On ``device="meta"`` the parameters have shapes and no storage;
    otherwise they are initialised on the CPU from ``seed`` and moved."""
    if (fused_bottleneck or fused_stem) and train:
        raise ValueError("fused_bottleneck and fused_stem are inference "
                         "kernels: need train=False")
    clip_config = clip_config or preset_from_name(cfg.clip_pretrain)
    meta = torch.device(device).type == "meta"
    with torch.device("meta" if meta else "cpu"):
        model = CRIS(
            clip_config,
            fpn_in=tuple(cfg.fpn_in),
            fpn_out=tuple(cfg.fpn_out),
            vis_dim=cfg.vis_dim,
            num_layers=cfg.num_layers,
            num_head=cfg.num_head,
            dim_ffn=cfg.dim_ffn,
            dropout=cfg.dropout,
            fold_bn=fold_bn,
            pos_grid=pos_grid,
            fused_bottleneck=fused_bottleneck,
            fused_stem=fused_stem,
        )
    if cfg.get("remat", False):
        for mod in model.modules():
            if isinstance(mod, (Bottleneck, ResidualAttentionBlock,
                                TransformerDecoderLayer)):
                mod.remat = True
    if not meta:
        init_weights(model, seed).to(device)
    return model.train(train)


def param_group_label(name: str) -> str:
    """'backbone' for CLIP parameters except the positional embeddings,
    'head' for everything else (cris_tpu/models/__init__.py:75-82, over
    the port's parameter names)."""
    if name.startswith("backbone.") and "positional_embedding" not in name:
        return "backbone"
    return "head"


__all__ = [
    "AttentionPool2d", "BatchNorm", "Bottleneck", "CLIP", "CLIPConfig",
    "CLIP_PRESETS", "CRIS", "ConvBNReLU", "CoordConv", "Dropout", "FPN",
    "LayerNormF32", "LinearBNReLU", "ModifiedResNet", "MultiheadAttention",
    "Projector",
    "ResidualAttentionBlock", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "bce_with_logits", "build_segmenter",
    "init_weights", "param_group_label", "preset_from_name", "quick_gelu",
    "resolve_dtype",
]
