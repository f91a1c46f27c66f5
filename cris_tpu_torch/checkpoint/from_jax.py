"""JAX CRIS variables -> the port's state_dict.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (or anything ``np.asarray`` takes), in the JAX package's
``nn.scan``-stacked layout. Output: ``{key: np.ndarray}`` with exactly the
keys that ``cris_tpu.checkpoint.torch_convert.convert_cris_state_dict``
reads, so the two converters are inverses. The JAX package is not
imported; its layout rules are mirrored here:

- ``layer{s}_tail``, ``resblocks`` and ``layers`` carry a leading layer
  axis (``cris_tpu/checkpoint/stacking.py:94-114``) and are unstacked;
- conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in);
- the decoder's separate q/k/v projections are packed into ``in_proj_*``.

The image tower is the modified ResNet or the ViT (the inverse of the JAX
``_convert_vit_visual``); ``clip_from_jax`` carries a standalone CLIP's
variables (no ``backbone`` prefix, no head).

The "quant" collection (the int8 sites' calibrated ``act_scale``) maps
onto the port's sites by ``site_path`` / ``sites_of``: a site is the
port's conv module, the JAX one the module that sowed the scale (the
conv, its ``QuantConv`` child ``conv`` in a ConvBNReLU, or the upsample
fold itself); a stage tail's scales are stacked along axis 0 like its
parameters. ``quant_from_jax`` carries a whole collection across.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np

_STAGE_TAIL = re.compile(r"^(layer\d+)_tail$")


def _unstack(tree, n: int):
    if isinstance(tree, Mapping):
        parts = [{} for _ in range(n)]
        for key, value in tree.items():
            for i, sub in enumerate(_unstack(value, n)):
                parts[i][key] = sub
        return parts
    arr = np.asarray(tree)
    return [arr[i] for i in range(n)]


def _leading_dim(tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def unstack_scanned(tree):
    """Stacked scan families -> per-layer entries: ``resblocks`` ->
    ``resblocks_{i}``, ``layers`` -> ``layers_{i}``, ``layer{s}_tail`` ->
    ``layer{s}_{1..}`` (``layer{s}_0`` is stored on its own)."""
    if not isinstance(tree, Mapping):
        return tree
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        value = unstack_scanned(value)
        tail = _STAGE_TAIL.match(key)
        if key in ("resblocks", "layers") and isinstance(value, Mapping):
            for i, part in enumerate(_unstack(value, _leading_dim(value))):
                out[f"{key}_{i}"] = part
        elif tail and isinstance(value, Mapping):
            for i, part in enumerate(_unstack(value, _leading_dim(value))):
                out[f"{tail.group(1)}_{i + 1}"] = part
        else:
            out[key] = value
    return out


class _Emitter:
    """Writes torch keys from (params, batch_stats) subtrees."""

    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = np.asarray(value)

    def conv(self, key: str, p, bias: bool = False) -> None:
        self.put(f"{key}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if bias:
            self.put(f"{key}.bias", p["bias"])

    def dense(self, key: str, p) -> None:
        self.put(f"{key}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def norm(self, key: str, p) -> None:
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])

    def bn(self, key: str, p, s) -> None:
        self.norm(key, p)
        self.put(f"{key}.running_mean", s["mean"])
        self.put(f"{key}.running_var", s["var"])

    def conv_bn(self, key: str, p, s) -> None:
        """ConvBNReLU: conv -> ``{key}.0``, bn -> ``{key}.1``."""
        self.conv(f"{key}.0", p["conv"])
        self.bn(f"{key}.1", p["bn"], s["bn"])


def _visual(em: _Emitter, p, s, layers, prefix: str) -> None:
    for i in (1, 2, 3):
        em.conv(f"{prefix}.conv{i}", p[f"conv{i}"])
        em.bn(f"{prefix}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    for stage, blocks in enumerate(layers, start=1):
        for j in range(blocks):
            bp, bs = p[f"layer{stage}_{j}"], s[f"layer{stage}_{j}"]
            key = f"{prefix}.layer{stage}.{j}"
            for i in (1, 2, 3):
                em.conv(f"{key}.conv{i}", bp[f"conv{i}"])
                em.bn(f"{key}.bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
            if "downsample_conv" in bp:
                em.conv(f"{key}.downsample.0", bp["downsample_conv"])
                em.bn(f"{key}.downsample.1", bp["downsample_bn"],
                      bs["downsample_bn"])
    ap, aps, key = p["attnpool"], s["attnpool"], f"{prefix}.attnpool"
    em.put(f"{key}.positional_embedding", ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        em.dense(f"{key}.{name}", ap[name])
    em.conv(f"{key}.connect.0", ap["connect_conv"])
    em.bn(f"{key}.connect.1", ap["connect_bn"], aps["connect_bn"])


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _blocks(em: _Emitter, blocks, prefix: str) -> None:
    """CLIP's pre-LN blocks (``resblocks_{i}``) -> ``{prefix}.resblocks.i``
    with torch's packed attention parameters."""
    for i in range(len(blocks)):
        bp, key = blocks[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        em.put(f"{key}.attn.in_proj_weight",
               np.asarray(bp["attn_in_proj"]["kernel"]).T)
        em.put(f"{key}.attn.in_proj_bias", bp["attn_in_proj"]["bias"])
        em.dense(f"{key}.attn.out_proj", bp["attn_out_proj"])
        em.norm(f"{key}.ln_1", bp["ln_1"])
        em.norm(f"{key}.ln_2", bp["ln_2"])
        em.dense(f"{key}.mlp.c_fc", bp["mlp_c_fc"])
        em.dense(f"{key}.mlp.c_proj", bp["mlp_c_proj"])


def _vit(em: _Emitter, p, prefix: str) -> None:
    """The ViT tower (cris_tpu/checkpoint/torch_convert.py:189-206
    inverted)."""
    for name in ("class_embedding", "positional_embedding", "proj"):
        em.put(f"{prefix}.{name}", p[name])
    em.conv(f"{prefix}.conv1", p["conv1"])
    em.norm(f"{prefix}.ln_pre", p["ln_pre"])
    em.norm(f"{prefix}.ln_post", p["ln_post"])
    _blocks(em, p["transformer"], f"{prefix}.transformer")


def _text(em: _Emitter, p, prefix: str) -> None:
    em.put(_key(prefix, "token_embedding.weight"), p["token_embedding"])
    em.put(_key(prefix, "positional_embedding"), p["positional_embedding"])
    em.put(_key(prefix, "text_projection"), p["text_projection"])
    em.norm(_key(prefix, "ln_final"), p["ln_final"])
    _blocks(em, p["transformer"], _key(prefix, "transformer"))


def _clip(em: _Emitter, p, s, prefix: str) -> None:
    """A CLIP's image tower, text tower and ``logit_scale``."""
    visual = _key(prefix, "visual")
    if "class_embedding" in p["visual"]:
        _vit(em, p["visual"], visual)
    else:
        _visual(em, p["visual"], s["visual"], _stage_blocks(p["visual"]),
                visual)
    _text(em, p["text"], prefix)
    if "logit_scale" in p:
        em.put(_key(prefix, "logit_scale"), p["logit_scale"])


def _neck(em: _Emitter, p, s) -> None:
    em.put("neck.txt_proj.0.weight", np.asarray(p["txt_proj"]["linear"]["kernel"]).T)
    em.bn("neck.txt_proj.1", p["txt_proj"]["bn"], s["txt_proj"]["bn"])
    em.bn("neck.norm_layer.0", p["norm_layer"], s["norm_layer"])
    for name in ("f1_v_proj", "f2_v_proj", "f2_cat", "f3_v_proj", "f3_cat",
                 "f4_proj5", "f4_proj4", "f4_proj3", "aggr"):
        em.conv_bn(f"neck.{name}", p[name], s[name])
    em.conv_bn("neck.coordconv.0.conv1", p["coordconv_0"]["conv1"],
               s["coordconv_0"]["conv1"])
    em.conv_bn("neck.coordconv.1", p["coordconv_1"], s["coordconv_1"])


def _attention(em: _Emitter, key: str, p) -> None:
    qkv = [p[name] for name in ("q_proj", "k_proj", "v_proj")]
    em.put(f"{key}.in_proj_weight",
           np.concatenate([np.asarray(x["kernel"]).T for x in qkv], axis=0))
    em.put(f"{key}.in_proj_bias",
           np.concatenate([np.asarray(x["bias"]) for x in qkv], axis=0))
    em.dense(f"{key}.out_proj", p["out_proj"])


def _decoder(em: _Emitter, p) -> None:
    layers = {k: v for k, v in p.items() if k.startswith("layers_")}
    for i in range(len(layers)):
        lp, key = p[f"layers_{i}"], f"decoder.layers.{i}"
        _attention(em, f"{key}.self_attn", lp["self_attn"])
        _attention(em, f"{key}.multihead_attn", lp["multihead_attn"])
        for name in ("norm1", "norm2", "norm3", "self_attn_norm",
                     "cross_attn_norm"):
            em.norm(f"{key}.{name}", lp[name])
        em.dense(f"{key}.ffn.0", lp["ffn_fc1"])
        em.norm(f"{key}.ffn.3", lp["ffn_norm"])
        em.dense(f"{key}.ffn.4", lp["ffn_fc2"])
    em.norm("decoder.norm", p["norm"])


def _projector(em: _Emitter, p, s) -> None:
    em.conv_bn("proj.vis.1", p["vis_conv1"], s["vis_conv1"])
    em.conv_bn("proj.vis.3", p["vis_conv2"], s["vis_conv2"])
    em.conv("proj.vis.4", p["vis_out"], bias=True)
    em.dense("proj.txt", p["txt"])


def _stage_blocks(visual) -> tuple:
    counts = {}
    for key in visual:
        m = re.match(r"^layer(\d+)_(\d+)$", key)
        if m:
            stage = int(m.group(1))
            counts[stage] = max(counts.get(stage, 0), int(m.group(2)) + 1)
    return tuple(counts[s] for s in sorted(counts))


def from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CRIS variables (stacked layout) -> the port's state_dict as
    numpy arrays (views where no copy is needed)."""
    p = unstack_scanned(variables["params"])
    s = unstack_scanned(variables.get("batch_stats", {}))
    em = _Emitter()
    _clip(em, p["backbone"], s.get("backbone", {}), "backbone")
    _neck(em, p["neck"], s["neck"])
    _decoder(em, p["decoder"])
    _projector(em, p["proj"], s["proj"])
    return em.sd


def clip_from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CLIP variables (``visual``, ``text``, ``logit_scale``) -> the
    port's CLIP state_dict under OpenAI CLIP's keys."""
    em = _Emitter()
    _clip(em, unstack_scanned(variables["params"]),
          unstack_scanned(variables.get("batch_stats", {})), "")
    return em.sd


def load_jax_variables(model, variables: Mapping[str, Any]):
    """Load JAX variables into a port model (strict: every key matches)."""
    import torch

    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in from_jax(variables).items()}
    model.load_state_dict(sd, strict=True)
    return model


_VIS_SITES = {"1": "proj/vis_conv1", "3": "proj/vis_conv2", "4": "proj/vis_out"}


def site_path(name: str):
    """A port int8 site's module name -> (the JAX module path of its
    "quant" entry, its index along a stage tail's stacked axis or None)."""
    parts = name.split(".")
    if parts[:2] == ["backbone", "visual"]:
        rest = parts[2:]
        if len(rest) == 1:  # the s2d stem's conv2 / conv3
            return f"backbone/visual/{rest[0]}", None
        stage, block = rest[0], int(rest[1])
        conv = "downsample_conv" if rest[2] == "downsample" else rest[2]
        if block == 0:
            return f"backbone/visual/{stage}_0/{conv}", None
        return f"backbone/visual/{stage}_tail/{conv}", block - 1
    if parts[0] == "neck":
        if parts[1] in ("f2_cat", "aggr"):
            return f"neck/{parts[1]}", None
        if parts[1] == "coordconv":
            return ("neck/coordconv_0/conv1/conv" if parts[2] == "0"
                    else "neck/coordconv_1/conv"), None
        return f"neck/{parts[1]}/conv", None
    if parts[0] == "proj" and parts[1] == "vis":
        return _VIS_SITES[parts[2]], None
    raise KeyError(f"no JAX int8 site for {name!r}")


def sites_of(path: str, value) -> Dict[str, np.ndarray]:
    """A JAX "quant" entry (module path, act_scale) -> {port site name:
    scalar}; a stage tail's stacked entry gives one site per block."""
    value = np.asarray(value, np.float32)
    parts = path.split("/")
    if parts[:2] == ["backbone", "visual"]:
        if len(parts) == 3:
            return {f"backbone.visual.{parts[2]}": value}
        stage, block = parts[2].rsplit("_", 1)
        conv = "downsample.0" if parts[3] == "downsample_conv" else parts[3]
        if block == "tail":
            return {f"backbone.visual.{stage}.{i + 1}.{conv}": value[i]
                    for i in range(value.shape[0])}
        return {f"backbone.visual.{stage}.{block}.{conv}": value}
    if parts[0] == "neck":
        if parts[1] in ("f2_cat", "aggr"):
            return {f"neck.{parts[1]}.0": value}
        if parts[1] == "coordconv_0":
            return {"neck.coordconv.0.conv1.0": value}
        if parts[1] == "coordconv_1":
            return {"neck.coordconv.1.0": value}
        return {f"neck.{parts[1]}.0": value}
    if parts[0] == "proj":
        return {f"proj.vis.{k}" + ("" if k == "4" else ".0"): value
                for k, v in _VIS_SITES.items() if v == path}
    raise KeyError(f"no port int8 site for {path!r}")


def quant_from_jax(quant: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX "quant" collection (nested dicts of ``act_scale`` leaves) ->
    {port site name: f32 scalar}."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if key == "act_scale":
                out.update(sites_of("/".join(prefix), value))
            else:
                walk(value, prefix + (key,))
    walk(quant, ())
    return out
