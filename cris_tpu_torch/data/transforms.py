"""Host-side image preprocessing without OpenCV.

Counterpart of ``cris_tpu.data.transforms``: decoding (``data/codec.py``),
the letterbox affine, CLIP normalization, the cubic image warp with a
CLIP-mean border, the linear mask warp with a zero border and the cubic
inverse warp of a prediction with a zero border.

Both warps are a pure scale + translation, so ``cv2.warpAffine`` with
INTER_CUBIC separates into a product of two sampling matrices, each row
holding the 4 Keys-cubic (A = -0.75) taps of one output pixel. The
source coordinate is computed in float32, as OpenCV 5's warp kernels do
(older OpenCV rounded it to 1/32 pixel, INTER_BITS = 5), and a tap outside
the source takes the border value. The weights are applied in float64, so
a uint8 image may differ from OpenCV's by one level where the exact value
lies near a half. The linear mask warp separates the same way, with the
two bilinear taps of each output pixel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .codec import decode_image, decode_mask

__all__ = ["CLIP_MEAN", "CLIP_STD", "decode_image", "decode_mask",
           "get_transform_mats", "inverse_warp_prediction", "normalize_image",
           "warp_image", "warp_mask"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_A = -0.75


def get_transform_mats(ori_hw: Tuple[int, int], input_hw: Tuple[int, int]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward and inverse 2x3 affine matrices: original -> letterboxed."""
    ori_h, ori_w = ori_hw
    inp_h, inp_w = input_hw
    scale = min(inp_h / ori_h, inp_w / ori_w)
    new_h, new_w = ori_h * scale, ori_w * scale
    bias_x, bias_y = (inp_w - new_w) / 2.0, (inp_h - new_h) / 2.0
    mat = np.array([[scale, 0.0, bias_x], [0.0, scale, bias_y]], np.float64)
    inv = np.array([[1.0 / scale, 0.0, -bias_x / scale],
                    [0.0, 1.0 / scale, -bias_y / scale]], np.float64)
    return mat, inv


def normalize_image(img_rgb: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> normalized float32 HWC."""
    img = img_rgb.astype(np.float32) / 255.0
    return (img - CLIP_MEAN) / CLIP_STD


def _cubic_weights(frac: np.ndarray) -> np.ndarray:
    """(n, 4) Keys weights for taps at -1, 0, 1, 2 (OpenCV's
    interpolateCubic: the last weight closes the sum to 1)."""
    x = frac + 1.0
    w0 = ((_A * x - 5 * _A) * x + 8 * _A) * x - 4 * _A
    w1 = ((_A + 2) * frac - (_A + 3)) * frac * frac + 1
    y = 1.0 - frac
    w2 = ((_A + 2) * y - (_A + 3)) * y * y + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], axis=1)


def _linear_weights(frac: np.ndarray) -> np.ndarray:
    """(n, 2) bilinear weights for taps at 0, 1."""
    return np.stack([1.0 - frac, frac], axis=1)


def _axis_taps(out_size: int, in_size: int, scale: float, offset: float,
               cubic: bool = True):
    """Source taps of one axis for src = scale * dst + offset: 4 cubic
    taps at -1..2 or 2 linear taps at 0, 1 around floor(src).

    Returns (idx (n, taps) clipped into the source, w (n, taps) with the
    weights of taps outside the source set to 0, inside (n,) = sum of
    w)."""
    src = (np.arange(out_size, dtype=np.float32) * np.float32(scale)
           + np.float32(offset))
    base = np.floor(src)
    frac = (src - base).astype(np.float64)
    offsets = np.arange(-1, 3) if cubic else np.arange(2)
    idx = base.astype(np.int64)[:, None] + offsets[None, :]
    w = _cubic_weights(frac) if cubic else _linear_weights(frac)
    w = np.where((idx >= 0) & (idx < in_size), w, 0.0)
    return np.clip(idx, 0, in_size - 1), w, w.sum(axis=1)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """2x3 affine inverse, in OpenCV's order of operations."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def _warp(src: np.ndarray, mat: np.ndarray, out_hw: Tuple[int, int],
          border, cubic: bool = True) -> np.ndarray:
    """Separable cubic (or, with ``cubic=False``, linear) warp of
    (H, W[, C]) by the src -> dst affine ``mat`` (a scale + translation),
    as ``cv2.warpAffine`` maps it, in float64."""
    inv = _invert_affine(mat)
    if inv[0, 1] != 0.0 or inv[1, 0] != 0.0:
        raise ValueError("only scale + translation warps are separable")
    out_h, out_w = out_hw
    iy, wy, sy = _axis_taps(out_h, src.shape[0], inv[1, 1], inv[1, 2], cubic)
    ix, wx, sx = _axis_taps(out_w, src.shape[1], inv[0, 0], inv[0, 2], cubic)
    img = src.astype(np.float64)
    chan = (1,) * (img.ndim - 2)
    rows = sum(wy[:, k].reshape((-1, 1) + chan) * img[iy[:, k]]
               for k in range(wy.shape[1]))
    out = sum(wx[:, k].reshape((1, -1) + chan) * rows[:, ix[:, k]]
              for k in range(wx.shape[1]))
    inside = (sy[:, None] * sx[None, :]).reshape((out_h, out_w) + chan)
    return out + np.asarray(border, np.float64) * (1.0 - inside)


def warp_image(img_rgb: np.ndarray, mat: np.ndarray,
               input_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC image -> letterboxed uint8 image (cubic, CLIP-mean
    border rounded to uint8 as OpenCV rounds a uint8 border value)."""
    border = np.rint(CLIP_MEAN.astype(np.float64) * 255)
    out = _warp(img_rgb, mat, input_hw, border)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_mask(mask: np.ndarray, mat: np.ndarray,
              input_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) mask -> letterboxed float32 mask in [0, 1] (linear,
    zero border, divided by 255)."""
    out = _warp(mask, mat, input_hw, 0.0, cubic=False)
    return (out / 255.0).astype(np.float32)


def inverse_warp_prediction(pred: np.ndarray, inv_mat: np.ndarray,
                            ori_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) float prediction -> original resolution (cubic, zero border)."""
    out = _warp(pred, inv_mat, (int(ori_hw[0]), int(ori_hw[1])), 0.0)
    return out.astype(np.float32)
