"""The port's data layer (counterpart of cris_tpu/data): records, the
synthetic backend, the dataset, the loader, decoding (``codec``, a C++
decoder built at first use) and the numpy warps. No OpenCV."""

from .codec import decode_image, decode_mask, encode_png, read_mask
from .dataset import SPLIT_SIZES, RefDataset, open_backend
from .loader import RefDataLoader
from .records import RefPackReader, RefPackWriter, write_refpack
from .synthetic import SyntheticBackend, make_record
from .transforms import (CLIP_MEAN, CLIP_STD, get_transform_mats,
                         inverse_warp_prediction, normalize_image, warp_image,
                         warp_mask)

__all__ = ["CLIP_MEAN", "CLIP_STD", "RefDataLoader", "RefDataset",
           "RefPackReader", "RefPackWriter", "SPLIT_SIZES", "SyntheticBackend",
           "decode_image", "decode_mask", "encode_png", "get_transform_mats",
           "inverse_warp_prediction", "make_record", "normalize_image",
           "open_backend", "read_mask", "warp_image", "warp_mask",
           "write_refpack"]
