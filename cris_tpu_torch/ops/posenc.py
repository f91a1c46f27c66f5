"""Sine/cosine positional encodings for the VL decoder (numpy, computed
once per shape), the same layouts as ``cris_tpu.ops.posenc``."""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def sincos_1d(d_model: int, length: int) -> np.ndarray:
    """(length, d_model) interleaved sin/cos encoding."""
    if d_model % 2 != 0:
        raise ValueError(f"1-D sincos needs even dim, got {d_model}")
    pe = np.zeros((length, d_model), dtype=np.float32)
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@functools.lru_cache(maxsize=None)
def sincos_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """(height*width, d_model): the first half of the channels encode the
    x position, the second half the y position, each interleaved sin/cos."""
    if d_model % 4 != 0:
        raise ValueError(f"2-D sincos needs dim % 4 == 0, got {d_model}")
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div_term = np.exp(
        np.arange(0.0, half, 2, dtype=np.float64) * -(math.log(10000.0) / half)
    )
    pos_w = np.arange(width, dtype=np.float64)[:, None]
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :]
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :]
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None]
    pe[half + 1 :: 2] = np.cos(pos_h * div_term).T[:, :, None]
    return pe.reshape(d_model, height * width).T.copy()
