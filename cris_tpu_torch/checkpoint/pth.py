"""Trained CRIS ``.pth`` checkpoints -> the port's state_dict.

The port keeps CRIS.pytorch's module names, so a checkpoint written by
its ``train.py`` (``{"state_dict": model.state_dict(), ...}``, under
``module.`` when the model was wrapped for data parallel) loads with the
prefix stripped and nothing converted: the port's counterpart of
``cris_tpu.checkpoint.torch_convert.load_cris_checkpoint``
(cris_tpu/checkpoint/torch_convert.py:331-337), which converts the same
file to the JAX tree.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

BEST_NAME = "best_model.pth"  # what serving looks for under a model_dir


def load_cris_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a trained CRIS ``.pth`` file, on the CPU, with a
    leading ``module.`` stripped from every key. The file is unpickled
    (``weights_only=False``, as the JAX package reads it), so load only
    checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
