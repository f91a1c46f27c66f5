"""Flat config: ``CfgNode``, a YAML loader and the CRIS-R50 and
CRIS-R101 RefCOCO presets.

Counterpart of ``cris_tpu.utils.config``: two-level YAML files flatten
into one attribute-accessible dict. ``yaml`` is imported only by the
loader, so the presets below serve where PyYAML is absent
(``config_for`` picks one for its YAML path).
"""

from __future__ import annotations

import copy
import os


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
    """Load a two-level YAML file and flatten its sections (later sections
    win on a key collision)."""
    if not (os.path.isfile(file) and file.endswith(".yaml")):
        raise ValueError(f"{file} is not a yaml file")
    import yaml

    with open(file, "r") as f:
        raw = yaml.safe_load(f)
    flat = {}
    for section in raw:
        flat.update(raw[section])
    return CfgNode(flat)


# config/refcoco/cris_r50.yaml, flattened
_CRIS_R50_REFCOCO = dict(
    dataset="refcoco",
    train_lmdb="datasets/lmdb/refcoco/train.lmdb",
    train_split="train",
    val_lmdb="datasets/lmdb/refcoco/val.lmdb",
    val_split="val",
    mask_root="datasets/masks/refcoco",
    clip_pretrain="pretrain/RN50.pt",
    input_size=416,
    word_len=17,
    word_dim=1024,
    vis_dim=512,
    fpn_in=[512, 1024, 1024],
    fpn_out=[256, 512, 1024],
    sync_bn=True,
    num_layers=3,
    num_head=8,
    dim_ffn=2048,
    dropout=0.1,
    intermediate=False,
    workers=8,
    workers_val=4,
    epochs=50,
    milestones=[35],
    start_epoch=0,
    batch_size=64,
    batch_size_val=64,
    base_lr=0.0001,
    lr_decay=0.1,
    lr_multi=0.1,
    weight_decay=0.0,
    max_norm=0.0,
    manual_seed=0,
    print_freq=100,
    precision="bf16",
    pallas=True,
    remat=False,
    scan_unroll=0,
    wandb=False,
    profile_dir=None,
    exp_name="CRIS_R50",
    output_folder="exp/refcoco",
    save_freq=1,
    weight=None,
    resume=None,
    evaluate=True,
    dp_size=-1,
    tp_size=1,
    dist_url="tcp://localhost:3681",
    dist_backend="nccl",
    multiprocessing_distributed=True,
    world_size=1,
    rank=0,
    fold_bn_eval=True,
    test_split="val-test",
    test_lmdb="datasets/lmdb/refcoco/val.lmdb",
    visualize=False,
)


def cris_r50_refcoco() -> CfgNode:
    """A fresh copy of the CRIS-R50 RefCOCO configuration."""
    return CfgNode(copy.deepcopy(_CRIS_R50_REFCOCO))


# config/refcoco/cris_r101.yaml, flattened: R50's but for these keys
_CRIS_R101_REFCOCO = dict(_CRIS_R50_REFCOCO, clip_pretrain="pretrain/RN101.pt",
                          word_dim=512, fpn_in=[512, 1024, 512],
                          exp_name="CRIS_R101")


def cris_r101_refcoco() -> CfgNode:
    """A fresh copy of the CRIS-R101 RefCOCO configuration."""
    return CfgNode(copy.deepcopy(_CRIS_R101_REFCOCO))


_PRESETS = {os.path.join("config", "refcoco", "cris_r50.yaml"): cris_r50_refcoco,
            os.path.join("config", "refcoco", "cris_r101.yaml"): cris_r101_refcoco}


def config_for(path: str) -> CfgNode:
    """The configuration of a YAML file: the preset for the two RefCOCO
    files (matched on their last three path components, so no PyYAML is
    needed for them), else the file through ``load_cfg_from_cfg_file``."""
    key = os.path.join(*os.path.normpath(path).split(os.sep)[-3:])
    if key in _PRESETS:
        return _PRESETS[key]()
    return load_cfg_from_cfg_file(path)
