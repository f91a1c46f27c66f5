"""The port's data layer (counterpart of cris_tpu/data): records, the
synthetic backend, the dataset, the loader, decoding and encoding
(``codec``, a C++ library built at first use), the batched data plane
(``native``: one C++ call preprocesses a batch), the numpy warps and the
host pipeline's measurement (``host_bench``); for offline preparation,
the REFER API (``refer``) and the reference's LMDB shards
(``lmdb_backend``). No OpenCV."""

from .codec import (decode_image, decode_mask, encode_jpeg, encode_png,
                    read_mask)
from .dataset import SPLIT_SIZES, RefDataset, open_backend
from .host_bench import make_test_jpegs, measure_host_pipeline
from .loader import RefDataLoader
from .native import batch_preprocess
from .records import RefPackReader, RefPackWriter, write_refpack
from .synthetic import SyntheticBackend, make_record
from .transforms import (CLIP_MEAN, CLIP_STD, get_transform_mats,
                         inverse_warp_prediction, normalize_image, warp_image,
                         warp_mask)

__all__ = ["CLIP_MEAN", "CLIP_STD", "RefDataLoader", "RefDataset",
           "RefPackReader", "RefPackWriter", "SPLIT_SIZES", "SyntheticBackend",
           "batch_preprocess", "decode_image", "decode_mask", "encode_jpeg",
           "encode_png", "get_transform_mats", "inverse_warp_prediction",
           "make_record", "make_test_jpegs", "measure_host_pipeline",
           "normalize_image", "open_backend", "read_mask", "warp_image",
           "warp_mask", "write_refpack"]
