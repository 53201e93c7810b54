"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` (Hopper), one process per source started together, and linked
into one shared library, loaded with ``ctypes``. The
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
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

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


def _run_all(cmds) -> None:
    """Run the commands at once and wait for all; raise on any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> tuple[str, float]:
    """Compile the kernels if this source hash has no library yet.

    One ``nvcc`` per source, all started together, then one link.
    Returns ``(library path, seconds spent compiling)``; the seconds are 0
    when an existing build was reused.
    """
    out_dir = os.path.join(_BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, 0.0
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # objects and library go to private names first: a concurrent build
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        sources = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp_dir, os.path.basename(s) + ".o")
                for s in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                  for src, obj in zip(sources, objs)])
        tmp_lib = os.path.join(tmp_dir, _LIB_NAME)
        _run_all([[nvcc, *NVCC_ARCH, "-shared", "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, lib_path)
    return lib_path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()[0])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.marconet_fused_lrelu_fwd.argtypes = [p, p, p, ll, ll, i, p]
    lib.marconet_fused_lrelu_fwd.restype = i
    lib.marconet_fused_lrelu_bwd.argtypes = [p, p, p, p, ll, ll, i, p]
    lib.marconet_fused_lrelu_bwd.restype = i
    lib.marconet_sft_writeback.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, p]
    lib.marconet_sft_writeback.restype = i
    lib.marconet_sft_writeback_bwd.argtypes = [p, p, p, p, p,
                                               i, i, i, i, i, i, i, p]
    lib.marconet_sft_writeback_bwd.restype = i
    lib.marconet_conv3x3_same.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.marconet_conv3x3_same.restype = i
    lib.marconet_conv3x3_wgmma.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.marconet_conv3x3_wgmma.restype = i
    lib.marconet_conv3x3_f32.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.marconet_conv3x3_f32.restype = i
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
