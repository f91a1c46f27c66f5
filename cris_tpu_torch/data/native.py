"""The batched data plane (counterpart of cris_tpu/data/native.py).

``batch_preprocess`` decodes, orients, warps and normalises a whole batch
of images, and decodes and warps its masks, in one ``ctypes`` call into
``csrc/batch_preprocess.cc``, which runs the samples on a pool of C++
threads. ``ctypes`` releases the interpreter lock around the call, so a
batch takes the lock once instead of once per numpy operation of every
sample. The values equal the per-sample path's (``RefDataset.__getitem__``:
``codec``'s decoder, ``transforms``' numpy warps and normalisation) bit for
bit.

The library is ``data/codec.py``'s, built on first use. There is no
fallback: if it cannot be built or loaded, the call raises. The per-sample
path is taken only when ``CRIS_NATIVE=0`` (``available()``), as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from . import codec

ABI_VERSION = 1


def available() -> bool:
    """False when ``CRIS_NATIVE`` is 0 (or false): batches then go through
    the per-sample path. Says nothing about the library, which raises when
    it is used and cannot be built."""
    return os.environ.get("CRIS_NATIVE", "1") not in ("0", "false", "False")


def _library() -> ctypes.CDLL:
    lib = codec.load_library()
    version = lib.cris_data_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{codec.library_path().name}: data plane ABI "
                           f"{version}, this module binds {ABI_VERSION}")
    return lib


def _pointers(bufs: Sequence[bytes]):
    """ctypes arrays of the buffers' addresses and lengths (the address
    array keeps the bytes objects alive)."""
    bufs = [b if isinstance(b, bytes) else bytes(b) for b in bufs]
    return ((ctypes.c_char_p * len(bufs))(*bufs),
            (ctypes.c_size_t * len(bufs))(*map(len, bufs)))


def batch_preprocess(
    img_bytes: Sequence[bytes],
    mask_bytes: Optional[Sequence[bytes]],
    input_size: int,
    nthreads: Optional[int] = None,
    want_inverse: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """Decode, warp and normalise a batch of JPEG or PNG images (and, when
    given, decode and warp their masks) on ``nthreads`` C++ threads
    (default ``min(os.cpu_count(), n)``).

    Returns (images (N, S, S, 3) float32 NHWC RGB normalised, masks (N, S,
    S) float32 in [0, 1] or None, inverse affines (N, 2, 3) float64 or None
    without ``want_inverse``, original sizes (N, 2) int32). A sample that
    fails to decode raises ``ValueError`` naming its index in the batch and
    the decoder's message (the lowest such index)."""
    n = len(img_bytes)
    if input_size < 1:
        raise ValueError(f"input_size must be positive, got {input_size}")
    if mask_bytes is not None and len(mask_bytes) != n:
        raise ValueError(f"{n} images but {len(mask_bytes)} masks")
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, n)
    s = input_size
    images = np.empty((n, s, s, 3), np.float32)
    masks = np.empty((n, s, s), np.float32) if mask_bytes is not None else None
    inverse = np.empty((n, 2, 3), np.float64) if want_inverse else None
    ori = np.empty((n, 2), np.int32)
    if n == 0:
        return images, masks, inverse, ori
    lib = _library()
    img_ptrs, img_lens = _pointers(img_bytes)
    mask_ptrs, mask_lens = (_pointers(mask_bytes) if mask_bytes is not None
                            else (None, None))

    def ptr(a):
        return None if a is None else a.ctypes.data

    codec._call(lib.cris_batch_preprocess, img_ptrs, img_lens, mask_ptrs,
                mask_lens, n, s, int(nthreads), ptr(images), ptr(masks),
                ptr(inverse), ptr(ori))
    return images, masks, inverse, ori
