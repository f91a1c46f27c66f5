"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``cris_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a plain C interface,
under ``build/cris_tpu_torch/`` at the repository root. The library's name
carries a hash of the sources and flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is. The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>.log``.

Nothing here runs at import: ``load_library()`` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cris_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when the library was already built)
last_build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcris_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global last_build_seconds
    target = library_path()
    if target.is_file():
        last_build_seconds = 0.0
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # build under temporary names, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objects.append(obj)
        logs, failed = [], False
        for cmd, proc in procs:
            out, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            failed |= proc.returncode != 0
        if not failed:
            lib = os.path.join(tmp, "lib.so")
            cmd = [nvcc, "-shared", "-o", lib, *objects]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            failed = proc.returncode != 0
        last_build_seconds = time.perf_counter() - t0
        log = "\n".join(logs)
        target.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(lib, target)
    return target


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cris_attention_bse.argtypes = [
                p, p, p, p, p,          # q, k, v, kv_valid, out
                i, i, i, i, i, i, i,    # B, S, T, H, D, dtype, body
                ll, ll, ll, ll, ll, ll,  # q/k/v batch and row strides
                ctypes.c_float, p,      # scale, stream
            ]
            lib.cris_attention_bse.restype = i
            lib.cris_fused_attention.argtypes = [
                p, p, p, p, p,          # q, k, v, kv_valid, out
                i, i, i, i, i, i, i,    # B, S, T, H, D, dtype, body
                *[ll] * 12,             # q/k/v/out batch, head, row strides
                ctypes.c_float, p,      # scale, stream
            ]
            lib.cris_fused_attention.restype = i
            lib.cris_fused_matmul.argtypes = [
                p, p, p, p, p,          # x, w, bias, residual, out
                i, i, i, i, i,          # M, N, K, dtype, relu
                ll, ll, ll, ll, ll, ll,  # x, w, residual row/column strides
                p,                      # stream
            ]
            lib.cris_fused_matmul.restype = i
            lib.cris_fused_matmul_wgmma.argtypes = [
                p, p, p, p, p,          # x, w, bias, residual, out
                i, i, i, i,             # M, N, K, relu
                ll, i, ll,              # x row stride, w N-major?, w stride
                ll, ll, p,              # residual strides, stream
            ]
            lib.cris_fused_matmul_wgmma.restype = i
            lib.cris_layer_norm_fwd.argtypes = [
                p, p, p, p,             # x, scale, bias, y
                i, i, i,                # rows, C, dtype
                ctypes.c_float, p,      # eps, stream
            ]
            lib.cris_layer_norm_fwd.restype = i
            lib.cris_layer_norm_bwd.argtypes = [
                p, p, p, p, p, p,       # x, scale, g, dx, dscale/dbias parts
                i, i, i, i, i,          # rows, C, blocks, chunk, dtype
                ctypes.c_float, p,      # eps, stream
            ]
            lib.cris_layer_norm_bwd.restype = i
            f, u = ctypes.c_float, ctypes.c_uint
            dropout_tail = [
                ll, ll, ll, ll, ll, ll,  # q/k/v batch and row strides
                f, f,                   # scale, 1 / (1 - rate)
                u, u, u,                # keep threshold, seed words
                i, p,                   # batch offset, stream
            ]
            lib.cris_attention_dropout_fwd.argtypes = [
                p, p, p, p, p, p, p,    # q, k, v, kv_valid, out, lse, bits
                i, i, i, i, i, i, i,    # B, S, T, H, D, dtype, body
                *dropout_tail,
            ]
            lib.cris_attention_dropout_fwd.restype = i
            lib.cris_attention_dropout_bwd.argtypes = [
                p, p, p, p, p, p, p,    # q, k, v, kv_valid, out, lse, bits
                p, p, p, p, p,          # dout, delta (scratch), dq, dk, dv
                i, i, i, i, i, i, i,    # B, S, T, H, D, dtype, body
                *dropout_tail,
            ]
            lib.cris_attention_dropout_bwd.restype = i
            conv_tail = [
                i, i, i, i, i, i,       # B, H, W, then the widths and dtype
                ll, ll, ll, ll,         # input batch/row/column/channel strides
                ll, ll, ll, ll,         # output strides, the same order
                p,                      # stream
            ]
            lib.cris_bottleneck.argtypes = [
                p, p, p, p, p, p, p, p,  # x, w1, b1, w2, b2, w3, b3, out
                i, i, i, i, i, i, i,    # B, H, W, C, mid, dtype, body
                *conv_tail[6:],         # strides, stream
            ]
            lib.cris_bottleneck.restype = i
            lib.cris_bottleneck_plan.argtypes = [
                i, i, i, i, i, i,       # B, H, W, C, mid, pixel pairs
                ctypes.POINTER(ll), ctypes.POINTER(ctypes.c_double),
            ]
            lib.cris_bottleneck_plan.restype = i
            lib.cris_stem_pool.argtypes = [
                p, p, p, p, p, p, p, p,  # img, k1, b1, k2, b2, k3, b3, out
                i, *conv_tail[:6],      # B, H, W, C1, C2, C3, dtype
                i, i, i,                # body, requested tile Th, Tw
                *conv_tail[6:],         # strides, stream
            ]
            lib.cris_stem_pool.restype = i
            lib.cris_stem_plan.argtypes = [
                i, i, i, i, i, i, i, i,  # B, H, W, C1, C2, C3, Th, Tw
                ctypes.POINTER(ll), ctypes.POINTER(ctypes.c_double),
            ]
            lib.cris_stem_plan.restype = i
            lib.cris_int8_quantize.argtypes = [
                p, p, p,                # x, act_scale, q
                i, i, i, i, i, i,       # B, H, W, C, Cp, in dtype
                ll, ll, ll, ll,         # x batch/row/column/channel strides
                p,                      # stream
            ]
            lib.cris_int8_quantize.restype = i
            lib.cris_int8_conv.argtypes = [
                p, p, p, p, p, p, p,    # xq, w, k_scale, act_scale, bias,
                                        # out, split-K sums
                i, i, i, i, i, i, i,    # B, H, W, Cp, Ho, Wo, Co
                i, i, i, i, i,          # kh, kw, stride, pad top, pad left
                i, i,                   # out dtype, relu
                i, i, i, i, i,          # plan: bm, box pixels and rows,
                                        # split, grid
                ll, ll, ll, ll,         # out batch/row/column/channel strides
                p,                      # stream
            ]
            lib.cris_int8_conv.restype = i
            lib.cris_cuda_error_string.argtypes = [i]
            lib.cris_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.cris_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
