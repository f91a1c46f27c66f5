"""Flat config: ``CfgNode``, a YAML loader, ``--opts KEY VALUE``
overrides and the CRIS-R50 and CRIS-R101 RefCOCO configurations.

Counterpart of ``cris_tpu.utils.config``: two-level YAML files flatten
into one attribute-accessible dict. The files are read by
``yaml_subset`` (the standard library alone), so every config under
``config/`` reads the same with or without PyYAML.
"""

from __future__ import annotations

import copy
import os
from ast import literal_eval

from .yaml_subset import load_file


class CfgNode(dict):
    """A dict whose keys are also attributes."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else dict(init_dict)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                init_dict[k] = CfgNode(v)
        super().__init__(init_dict)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


def load_cfg_from_cfg_file(file: str) -> CfgNode:
    """Load a two-level YAML file through ``yaml_subset`` (what
    ``yaml.safe_load`` gives, on every machine) and flatten its sections
    (later sections win on a key collision)."""
    if not (os.path.isfile(file) and file.endswith(".yaml")):
        raise ValueError(f"{file} is not a yaml file")
    raw = load_file(file)
    flat = {}
    for section in raw:
        flat.update(raw[section])
    return CfgNode(flat)


def merge_cfg_from_list(cfg: CfgNode, cfg_list) -> CfgNode:
    """``cfg`` with ``--opts full.key value`` pairs applied: the last
    dotted component selects the key (the namespace is flat), an unknown
    key is an error, and each value is literal-eval decoded and coerced to
    the existing value's type (cris_tpu/utils/config.py:75-90)."""
    new_cfg = copy.deepcopy(cfg)
    if len(cfg_list) % 2 != 0:
        raise AssertionError("--opts must come in KEY VALUE pairs")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        subkey = full_key.split(".")[-1]
        if subkey not in cfg:
            raise AssertionError(f"Non-existent key: {full_key}")
        value = _coerce_value_type(_decode_cfg_value(v), cfg[subkey], full_key)
        setattr(new_cfg, subkey, value)
    return new_cfg


def _decode_cfg_value(v):
    """A raw string -> a Python literal when it is one (a bare word or a
    path stays a string)."""
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value_type(replacement, original, full_key):
    """The replacement, when its type matches the original's (anything
    replaces a None; list <-> tuple and int -> float convert)."""
    original_type, replacement_type = type(original), type(replacement)
    if replacement_type == original_type or original is None:
        return replacement
    if replacement_type is tuple and original_type is list:
        return list(replacement)
    if replacement_type is list and original_type is tuple:
        return tuple(replacement)
    if replacement_type is int and original_type is float:
        return float(replacement)
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}")


# the repository's root, where config/ is
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config_for(path: str) -> CfgNode:
    """The configuration of a YAML file through ``load_cfg_from_cfg_file``;
    a path that is not there is looked up by its last three components
    (``config/<dataset>/<file>``) under the repository's root."""
    if not os.path.isfile(path):
        parts = os.path.normpath(path).split(os.sep)[-3:]
        in_repo = os.path.join(REPO_ROOT, *parts)
        if os.path.isfile(in_repo):
            path = in_repo
    return load_cfg_from_cfg_file(path)


def cris_r50_refcoco() -> CfgNode:
    """A fresh copy of the CRIS-R50 RefCOCO configuration
    (``config/refcoco/cris_r50.yaml``)."""
    return config_for(os.path.join("config", "refcoco", "cris_r50.yaml"))


def cris_r101_refcoco() -> CfgNode:
    """A fresh copy of the CRIS-R101 RefCOCO configuration
    (``config/refcoco/cris_r101.yaml``)."""
    return config_for(os.path.join("config", "refcoco", "cris_r101.yaml"))
