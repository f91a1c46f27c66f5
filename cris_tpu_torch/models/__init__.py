"""Model registry and builder (counterpart of cris_tpu/models/__init__.py:33-73).

``build_segmenter(cfg, device, seed)`` builds CRIS from a flat config with
seeded random weights (a ``torch.Generator``), on the card by default, or
with no storage at all on the ``meta`` device; ``fold_bn=True`` builds the
BN-folded inference variant; ``clip_config`` (a CLIP archive's, from
``checkpoint.torch_convert``) takes the place of the preset that
``cfg.clip_pretrain`` names. Weights from the JAX package load through
``cris_tpu_torch.checkpoint.from_jax``. ``param_group_label`` splits the
parameters into the optimizer's backbone and head groups. ``shard_model``
(``build_segmenter``'s ``grid``) splits the full model over a model group
for tensor parallel, by ``parallel.tensor.TP_RULES``.

Precision (cris_tpu/models/__init__.py:48-66): "bf16" (autocast) or
"fp32", and "int8": bf16 autocast, the three exact bf16 graph rewrites
on (the fused pools, the s2d stem, the upsample folds), and on the
BN-folded eval model the int8 sites (``layers.QuantConfig``,
``checkpoint.calibrate`` for their scales). An unknown precision raises.
At bf16 the rewrites stay off: the bench's A/B (``python3 -m
cris_tpu_torch.bench --ab rewrites``) decides whether they become the
default.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..parallel import Grid
from ..parallel.tensor import (ColumnDropout, ColumnParallelLinear,
                               RowParallelLinear, ShardedLayerNormF32,
                               VocabParallelEmbedding, make_plan)

from .clip import CLIP, CLIP_PRESETS, CLIPConfig, preset_from_name
from .clip_resnet import AttentionPool2d, Bottleneck, ModifiedResNet
from .clip_text import PackedAttention, ResidualAttentionBlock, Transformer
from .clip_vit import VisionTransformer
from .decoder import (MultiheadAttention, TransformerDecoder,
                      TransformerDecoderLayer)
from .layers import (Audit, BatchNorm, Calibration, CatUpConvBNReLU,
                     ConvBNReLU, CoordConv, Dropout, LayerNormF32,
                     LinearBNReLU, QuantConfig, QuantConv, UpConvBNReLU,
                     auditing, calibrating, enable_int8, int8_sites,
                     quick_gelu)
from .neck import FPN
from .projector import Projector
from .segmenter import CRIS, bce_with_logits

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "int8": torch.bfloat16,
           "fp32": None, "float32": None, "f32": None}


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config precision -> autocast dtype (None = plain f32; int8 computes
    in bf16 around its int8 convs)."""
    key = str(name).lower()
    if key not in _DTYPES:
        raise ValueError(f"unknown precision {name!r}")
    return _DTYPES[key]


def is_int8(cfg) -> bool:
    """``precision: int8`` (or the JAX package's ``quant_int8: true``)."""
    return (str(cfg.get("precision", "bf16")).lower() == "int8"
            or bool(cfg.get("quant_int8", False)))


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
        elif isinstance(mod, VisionTransformer):
            scale = mod.proj.shape[0] ** -0.5
            for t in (mod.class_embedding, mod.positional_embedding,
                      mod.proj):
                normal_(t, scale)
        elif isinstance(mod, CLIP):
            normal_(mod.positional_embedding, 0.01)
            normal_(mod.text_projection, mod.text_projection.shape[0] ** -0.5)
            mod.logit_scale.fill_(math.log(1 / 0.07))
    return model


def build_segmenter(cfg, device="cuda", seed: int = 0, train: bool = False,
                    fold_bn: bool = False, pos_grid: Optional[int] = None,
                    fused_bottleneck: Union[bool, str] = False,
                    fused_stem: bool = False,
                    clip_config: Optional[CLIPConfig] = None,
                    rewrites: Optional[bool] = None,
                    quant: Optional[QuantConfig] = None,
                    grid: Optional[Grid] = None) -> CRIS:
    """CRIS from a flat config (see config/*/*.yaml), in eval mode, or in
    train mode (batch-statistics BN, dropout) with ``train=True``, on the
    card unless ``device`` says otherwise. The CLIP architecture is
    ``clip_config``, else the preset ``cfg.clip_pretrain`` names; a ViT
    image tower is refused (a ValueError): the neck takes the ResNet's
    three scales, as in the JAX package.
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

    ``rewrites`` (None: on exactly when the precision is int8) builds the
    exact bf16 graph rewrites: the fused pools and the s2d stem
    (``clip_resnet``), the upsample folds (``neck``, ``projector``); the
    parameters and keys are unchanged. ``quant``: the int8 sites' gates
    (``layers.QuantConfig``; None: its defaults when the precision is
    int8), set on the BN-folded eval model only, as the JAX package sets
    ``quant_int8`` (``layers.enable_int8``).

    On ``device="meta"`` the parameters have shapes and no storage;
    otherwise they are initialised on the CPU from ``seed`` and moved.
    With a ``grid`` of more than one model rank the full model, so
    initialised, is then split over its model group (``shard_model``):
    every rank starts from one process's init."""
    if (fused_bottleneck or fused_stem) and train:
        raise ValueError("fused_bottleneck and fused_stem are inference "
                         "kernels: need train=False")
    clip_config = clip_config or preset_from_name(cfg.clip_pretrain)
    if clip_config.is_vit:
        raise ValueError("CRIS over a ViT image tower is not supported: "
                         "CRIS's neck takes the ResNet's three feature "
                         "scales (C3, C4, C5), and a ViT gives one")
    resolve_dtype(cfg.get("precision", "bf16"))  # an unknown one raises
    int8 = is_int8(cfg)
    if rewrites is None:
        rewrites = int8
    if quant is None and int8:
        quant = QuantConfig()
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
            rewrites=rewrites,
        )
    if fold_bn and not train:
        enable_int8(model, quant)
    if cfg.get("remat", False):
        for mod in model.modules():
            if isinstance(mod, (Bottleneck, ResidualAttentionBlock,
                                TransformerDecoderLayer)):
                mod.remat = True
    if not meta:
        init_weights(model, seed)
    if grid is not None:
        shard_model(model, grid)
    return model.to(device).train(train)


def shard_model(model: nn.Module, grid: Grid) -> nn.Module:
    """Split a full CRIS over ``grid``'s model group in place, as the JAX
    mesh's rules shard it (``parallel.tensor.TP_RULES``, each only where
    the group divides its dimension): the decoder's attentions by heads
    (``MultiheadAttention.shard``), its FFN (fc1 column-parallel, its
    LayerNorm and inner dropout on the rank's hidden columns, fc2
    row-parallel), the text MLPs (c_fc column-, c_proj row-parallel), the
    token embedding by vocabulary rows, and the projector's kernel
    generator column-parallel with its output gathered. Records the plan
    (``tp_plan``, {key: Shard}) and the grid (``tp_grid``) on the model,
    which ``parallel.tensor``'s full state functions read, and leaves
    every module in the model's mode (train or eval). No int8 site is
    split: the sites are convs, and the rules split only linears and
    embeddings, so an int8 model keeps its scales and K8 on every rank. A
    grid of one model rank leaves the model as it is."""
    if grid.model_size == 1:
        return model
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    plan = make_plan(shapes, grid.model_size)
    for name, mod in list(model.named_modules()):
        key = f"{name}." if name else ""
        if isinstance(mod, MultiheadAttention):
            if f"{key}in_proj_weight" in plan:
                mod.shard(grid)
        elif isinstance(mod, TransformerDecoderLayer):
            if f"{key}ffn.0.weight" in plan:
                ffn = mod.ffn
                ffn[0] = ColumnParallelLinear(ffn[0], grid)
                ffn[2] = ColumnDropout(ffn[2].p, grid)
                ffn[3] = ShardedLayerNormF32(ffn[3], grid)
                ffn[4] = RowParallelLinear(ffn[4], grid)
        elif isinstance(mod, ResidualAttentionBlock):
            if f"{key}mlp.c_fc.weight" in plan:
                mod.mlp.c_fc = ColumnParallelLinear(mod.mlp.c_fc, grid)
                mod.mlp.c_proj = RowParallelLinear(mod.mlp.c_proj, grid)
        elif isinstance(mod, CLIP):
            if f"{key}token_embedding.weight" in plan:
                mod.token_embedding = VocabParallelEmbedding(
                    mod.token_embedding, grid)
        elif isinstance(mod, Projector):
            if f"{key}txt.weight" in plan:
                mod.txt = ColumnParallelLinear(mod.txt, grid, gather=True)
    local = model.state_dict()
    for k, spec in plan.items():  # every planned key was split, once
        assert local[k].shape[spec.dim] * grid.model_size == \
            shapes[k][spec.dim], k
    model.tp_plan, model.tp_grid = plan, grid
    # the new modules start in train mode: an eval model would drop out
    return model.train(model.training)


def param_group_label(name: str) -> str:
    """'backbone' for CLIP parameters except the positional embeddings,
    'head' for everything else (cris_tpu/models/__init__.py:75-82, over
    the port's parameter names)."""
    if name.startswith("backbone.") and "positional_embedding" not in name:
        return "backbone"
    return "head"


__all__ = [
    "AttentionPool2d", "Audit", "BatchNorm", "Bottleneck", "CLIP",
    "CLIPConfig", "CLIP_PRESETS", "CRIS", "Calibration", "CatUpConvBNReLU",
    "ConvBNReLU", "CoordConv", "Dropout", "FPN", "LayerNormF32",
    "LinearBNReLU", "ModifiedResNet", "MultiheadAttention", "Projector",
    "QuantConfig", "QuantConv", "ResidualAttentionBlock", "Transformer",
    "TransformerDecoder", "TransformerDecoderLayer", "UpConvBNReLU",
    "VisionTransformer", "auditing", "bce_with_logits", "build_segmenter",
    "calibrating", "enable_int8", "init_weights", "int8_sites", "is_int8",
    "param_group_label", "preset_from_name", "quick_gelu", "resolve_dtype",
    "shard_model",
]
