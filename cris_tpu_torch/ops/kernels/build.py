"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``cris_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, under
``build/cris_tpu_torch/`` at the repository root. The library's name
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    # build under a temporary name, then rename: a concurrent or cut-off
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    target.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, target)
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
                i, i, i, i, i, i,       # B, S, T, H, D, dtype
                ll, ll, ll, ll, ll, ll,  # q/k/v batch and row strides
                ctypes.c_float, p,      # scale, stream
            ]
            lib.cris_attention_bse.restype = i
            lib.cris_cuda_error_string.argtypes = [i]
            lib.cris_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.cris_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
