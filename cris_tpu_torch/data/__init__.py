"""Host-side data transforms of the port (numpy, no OpenCV)."""

from .transforms import (CLIP_MEAN, CLIP_STD, get_transform_mats,
                         inverse_warp_prediction, normalize_image, warp_image)

__all__ = ["CLIP_MEAN", "CLIP_STD", "get_transform_mats",
           "inverse_warp_prediction", "normalize_image", "warp_image"]
