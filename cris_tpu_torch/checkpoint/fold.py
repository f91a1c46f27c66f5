"""Eval-time BatchNorm folding on the port's state dicts (counterpart of
cris_tpu/checkpoint/fold.py).

Every conv/linear + BN pair's eval affine goes into the preceding weight:

  weight' = weight * inv    (inv = bn.weight / sqrt(running_var + eps), per
                             output channel)
  bias'   = bn.bias - running_mean * inv   (+ bias * inv where the layer
                                            already had one)

in float64, stored in float32, as the JAX package's ``_fold_pair`` does.
Pairs are found by CRIS.pytorch's names: ``convN``/``bnN`` siblings (the
stem, the bottlenecks) and ``0``/``1`` children of one Sequential
(``downsample``, attnpool's ``connect``, ConvBNReLU, LinearBNReLU, so the
neck, CoordConv and the projector). The FPN's ``norm_layer`` BN
normalises a product of features, has no layer before it, and stays. The
result loads into a model built with ``fold_bn=True``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize2d

BN_EPS = 1e-5
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")
_POS_EMBED = "attnpool.positional_embedding"


def _pairs(keys) -> List[Tuple[str, str]]:
    """(layer prefix, BN prefix) of every foldable pair in ``keys``."""
    pairs = []
    for key in keys:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        parent, dot, leaf = bn.rpartition(".")
        if leaf.startswith("bn") and leaf[2:].isdigit():
            layer = f"{parent}{dot}conv{leaf[2:]}"
        elif leaf == "1":
            layer = f"{parent}{dot}0"
        else:
            continue
        if f"{layer}.weight" in keys:
            pairs.append((layer, bn))
    return pairs


def fold_pos_embed(pe: torch.Tensor, grid: int) -> torch.Tensor:
    """Pre-resize the attnpool embedding ((sd^2 + 1, C)) to ``grid``^2:
    the bicubic resize that AttentionPool2d runs every forward, done once
    in float64 (the JAX package's ``_fold_pos_embed``). Row 0, the CLS
    slot, is kept as it is."""
    sd = int(round((pe.shape[0] - 1) ** 0.5))
    if sd == grid:
        return pe
    c = pe.shape[1]
    g = pe[1:].double().reshape(1, sd, sd, c).permute(0, 3, 1, 2)
    g = resize2d(g, (grid, grid), "bicubic", align_corners=False)
    g = g.permute(0, 2, 3, 1).reshape(grid * grid, c)
    return torch.cat([pe[:1].float(), g.float()])


def fold_batchnorm(state_dict: Mapping[str, object],
                   input_resolution: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """An unfolded state dict (tensors or arrays, the port's names) -> the
    state dict of the ``fold_bn=True`` model, in float32.

    input_resolution: when given, the attnpool embedding is pre-resized to
    the (input_resolution // 32)^2 grid as well (``fold_pos_embed``), for
    a model built with ``pos_grid=input_resolution // 32``."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
          for k, v in state_dict.items()}
    out = dict(sd)
    for layer, bn in _pairs(sd):
        gamma, beta, mean, var = (sd[f"{bn}.{n}"].double() for n in _BN_KEYS)
        inv = gamma / torch.sqrt(var + BN_EPS)
        weight = sd[f"{layer}.weight"].double()
        out[f"{layer}.weight"] = (
            weight * inv.reshape(-1, *[1] * (weight.dim() - 1))).float()
        bias = beta - mean * inv
        if f"{layer}.bias" in sd:
            bias = bias + sd[f"{layer}.bias"].double() * inv
        out[f"{layer}.bias"] = bias.float()
        for n in _BN_KEYS:
            del out[f"{bn}.{n}"]
    if input_resolution is not None:
        for key in out:
            if key.endswith(_POS_EMBED):
                out[key] = fold_pos_embed(out[key], input_resolution // 32)
    return {k: v.float() for k, v in out.items()}
