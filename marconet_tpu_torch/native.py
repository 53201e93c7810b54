"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` (Hopper) into one shared library, loaded with ``ctypes``. The
build runs at first use, never at import, into
``build/marconet_tpu_torch/<hash of the sources>/`` beside the package, so
a checkout builds its own library and an edited source rebuilds it.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise on a nonzero code (see :func:`check`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                           "marconet_tpu_torch")
_LIB_NAME = "libmarconet_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sources():
    names = sorted(n for n in os.listdir(_CSRC)
                   if n.endswith((".cu", ".cuh")))
    return [os.path.join(_CSRC, n) for n in names]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "marconet_tpu_torch need the CUDA toolkit to build")


def build() -> tuple[str, float]:
    """Compile the kernels if this source hash has no library yet.

    Returns ``(library path, seconds spent compiling)``; the seconds are 0
    when an existing build was reused.
    """
    out_dir = os.path.join(_BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, 0.0
    os.makedirs(out_dir, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()[0])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.marconet_fused_lrelu_fwd.argtypes = [p, p, p, ll, ll, i, p]
    lib.marconet_fused_lrelu_fwd.restype = i
    lib.marconet_sft_writeback.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, p]
    lib.marconet_sft_writeback.restype = i
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_hopper(device) -> None:
    """The library is built for sm_90a only; refuse any other card."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"marconet_tpu_torch kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")
