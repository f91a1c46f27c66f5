"""Activation-scale calibration of the int8 sites (counterpart of
cris_tpu/checkpoint/calibrate.py).

    scales = calibrate_act_scales(model, batches)       # folded int8 model
    save_act_scales(path, scales, min_ch=64, ...)       # quant_scales.npz
    scales, gates = load_act_scales(path)
    set_act_scales(model, scales)                       # static int8

The statistic is a running maximum over the batches of each site's input
maxabs (or, with ``pct``, of the pct-th percentile of |x|, the JAX
package's CRIS_INT8_CALIB_PCT), and a scale is statistic / 127 + 1e-12
in f32.

The ``.npz`` format is the JAX package's: one entry per JAX module path
("backbone/visual/layer1_0/conv2/act_scale", a stage tail's stacked along
axis 0), plus ``__min_ch__``, ``__pooled_min_ch__`` and
``__upfold_min_ch__``, the gates the calibration ran with. A file written
by either package loads into the other. The recorded gates set the site
set at serving (``quant_config``), as the JAX loader sets its env gates.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.layers import QuantConfig, calibrating, enable_int8, int8_sites
from ..ops.quant import EPS, over_127
from .from_jax import site_path, sites_of

GATES = {"__min_ch__": "min_ch", "__pooled_min_ch__": "pooled_min_ch",
         "__upfold_min_ch__": "upfold_min_ch"}


@torch.no_grad()
def calibrate_act_scales(model: torch.nn.Module,
                         batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                         pct: float = 0.0,
                         dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """Run the BN-folded eval model with int8 on (``enable_int8``) over
    (img, word) batches, its sites running plain, and return {site name:
    f32 scale}. ``dtype``: the autocast dtype of the forwards (None: f32)."""
    sites = int8_sites(model)
    names = {mod: name for name, mod in sites.items()}
    if model.training:
        raise ValueError("calibrate_act_scales: the model must be in eval "
                         "mode")
    stats, seen = {}, False
    for img, word in batches:
        seen = True
        device = img.device
        with calibrating(pct) as cal, torch.autocast(
                device.type, dtype=dtype or torch.bfloat16,
                enabled=dtype is not None):
            model(img, word)
        if not cal.stats:
            raise ValueError(
                "calibrate_act_scales: no int8 site engaged -- is the model "
                "BN-folded, in eval mode and built with precision int8 (or "
                "a QuantConfig), and are any convs wide enough?")
        for mod, stat in cal.stats.items():
            name = names[mod]
            stats[name] = stat if name not in stats else torch.maximum(
                stats[name], stat)
    if not seen:
        raise ValueError("calibrate_act_scales: no batches provided")
    return {name: over_127(stat.float()) + EPS for name, stat in stats.items()}


def set_act_scales(model: torch.nn.Module,
                   scales: Dict[str, torch.Tensor]) -> int:
    """Give each int8 site of ``model`` its scale (on its device); a site
    without one keeps None (dynamic or plain). Returns the sites set;
    raises on a scale for a site the model does not have."""
    sites = int8_sites(model)
    unknown = sorted(set(scales) - set(sites))
    if unknown:
        raise KeyError(f"scales for sites the model does not have: "
                       f"{unknown[:5]}")
    for name, mod in sites.items():
        value = scales.get(name)
        if value is not None:
            value = (value.detach().float() if torch.is_tensor(value) else
                     torch.tensor(np.array(value, np.float32)))
            value = value.reshape(()).to(mod.weight.device, copy=True)
        mod.act_scale = value
    return sum(name in scales for name in sites)


def save_act_scales(path: str, scales: Dict[str, torch.Tensor],
                    min_ch: Optional[int] = None,
                    pooled_min_ch: Optional[int] = None,
                    upfold_min_ch: Optional[int] = None) -> None:
    """Write {site name: scale} as the JAX package's flat ``.npz`` (module
    path -> array, stage tails stacked), with the gates it was taken at."""
    flat: Dict[str, Dict[int, float]] = {}
    plain: Dict[str, np.ndarray] = {}
    for name, value in scales.items():
        path_, index = site_path(name)
        v = np.asarray(torch.as_tensor(value).detach().cpu(), np.float32)
        if index is None:
            plain[f"{path_}/act_scale"] = v.reshape(())
        else:
            flat.setdefault(f"{path_}/act_scale", {})[index] = float(v)
    for key, by_index in flat.items():
        n = max(by_index) + 1
        if sorted(by_index) != list(range(n)):
            raise ValueError(f"{key}: a stage tail's scales must cover "
                             f"every block, got {sorted(by_index)}")
        plain[key] = np.asarray([by_index[i] for i in range(n)], np.float32)
    for key, value in zip(GATES, (min_ch, pooled_min_ch, upfold_min_ch)):
        if value is not None:
            plain[key] = np.asarray(int(value))
    np.savez(path, **plain)


def load_act_scales(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """(scales {site name: f32 scalar}, gates {QuantConfig field: value})
    of a ``.npz`` written by ``save_act_scales`` or by the JAX package."""
    scales: Dict[str, np.ndarray] = {}
    gates: Dict[str, int] = {}
    with np.load(path) as z:
        for key in z.files:
            if key in GATES:
                gates[GATES[key]] = int(z[key])
            elif key.endswith("/act_scale"):
                scales.update(sites_of(key[:-len("/act_scale")], z[key]))
    return scales, gates


def quant_config(gates: Dict[str, int], **flags) -> QuantConfig:
    """The QuantConfig of a scale file's gates (the defaults for the ones
    it does not record)."""
    return QuantConfig(**gates, **flags)


SCALES_NAME = "quant_scales.npz"


def attach_act_scales(model: torch.nn.Module, path: str) -> int:
    """Serve ``model`` (BN-folded, built at precision int8) with the scales
    of ``path``: its gates set the site set (``enable_int8``), then each
    site gets its scale. Returns the sites with a scale."""
    scales, gates = load_act_scales(path)
    enable_int8(model, quant_config(gates))
    return set_act_scales(model, scales)
