"""3x3 stride-1 zero-SAME convolution: kernel K3 and its plain version.

Counterpart of ``marconet_tpu/ops/pallas_conv.py``. The TPU kernel it
replaces is ``_conv3x3_kernel`` (``marconet_tpu/ops/pallas_conv.py:39``,
launched by ``conv3x3_same``), written for the SR net's windowed SFT conv
stacks (fuse, scale and shift over B*N windows of 32x32 / 64x64 pixels at
256-512 -> 256 channels). No model of the JAX package calls it, and no
model of the port does: its path is the op itself, at those shapes.

The layouts are the JAX package's: x (N, H, W, CI) NHWC, w (3, 3, CI, CO)
HWIO, the result (N, H, W, CO) in ``x``'s dtype, the sum taken in f32 and
rounded once. K3 is forward-only, as the JAX kernel is (it has no
``custom_vjp``): the result carries no autograd graph.

On CPU tensors :func:`conv3x3_same` runs :func:`conv3x3_same_plain`; on
CUDA tensors it launches one of K3's three kernels or raises. Which one is
a rule on the inputs, :func:`conv3x3_path`, not a fallback:

- ``"fma"`` (``csrc/conv3x3_f32.cu``): every f32 input; 128 x 128 tiles
  of full f32 FMAs on the FP32 pipes (no TF32), 8 x 8 sums a thread;
- ``"wgmma"`` (``csrc/conv3x3_wgmma.cu``): TMA loads feeding Hopper's
  ``wgmma`` through an mbarrier ring, for bf16 inputs that TMA can tile
  (the SFT window convs);
- ``"mma_sync"`` (``csrc/conv3x3.cu``): the general bf16 kernel,
  ``mma.sync`` tensor cores, for every other bf16 input.

A launch on any path adds one to ``conv3x3_same.launches`` and to
``conv3x3_same.launches_by_path[path]``. The TPU kernel's 256 / 128
channel blocks were a VMEM tiling rule, not part of the function: both
versions take any CI and CO. K3 is bound by operations; the sources say
what their designs do about that.
"""

from __future__ import annotations

import torch

from marconet_tpu_torch import native

CI_BLOCK = 256   # the TPU kernel's input-channel block (_KBLK)
WGMMA_TILE_PIXELS = 128   # pixels of the wgmma kernel's M tile


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_same: x must be (N, H, W, CI) and w "
                         f"(3, 3, CI, CO); got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_same: w has {w.shape[2]} input channels,"
                         f" x has {x.shape[3]}")
    if w.dtype != x.dtype:
        raise ValueError(f"conv3x3_same: x is {x.dtype}, w is {w.dtype}")
    if w.device != x.device:
        raise ValueError("conv3x3_same: x and w are on different devices")


def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in the TPU kernel's arithmetic.

    For each block of 256 input channels and each tap (dy, dx), the
    edge-sliced shifted window of ``x`` times ``w[dy, dx]`` is added into
    an f32 accumulator over the output rows and columns that tap reaches;
    the sum is rounded once to ``x``'s dtype. Same contract as
    :func:`conv3x3_same`.
    """
    _check(x, w)
    n, h, wd, ci = x.shape
    acc = torch.zeros(n, h, wd, w.shape[3], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, ci, CI_BLOCK):
        xb = x[..., k0:k0 + CI_BLOCK].float()
        wb = w[:, :, k0:k0 + CI_BLOCK].float()
        for dy in range(3):
            oy = dy - 1
            rs, m = max(0, -oy), h - abs(oy)
            for dx in range(3):
                ox = dx - 1
                cs, wv = max(0, -ox), wd - abs(ox)
                if m <= 0 or wv <= 0:
                    continue
                xs = xb[:, rs + oy:rs + oy + m, cs + ox:cs + ox + wv]
                acc[:, rs:rs + m, cs:cs + wv] += xs @ wb[dy, dx]
    return acc.to(x.dtype)


def conv3x3_path(shape_x, shape_w, dtype, aligned: bool) -> str:
    """Which CUDA kernel K3 runs for x of ``shape_x`` (N, H, W, CI) and w
    of ``shape_w`` (3, 3, CI, CO) in ``dtype``.

    ``"fma"`` for every f32 input, whatever its shape or alignment (the
    kernel takes 16-byte loads where it can). ``"wgmma"`` when TMA can
    tile the inputs: bf16; CI and CO multiples of 8 (16-byte strides; a
    CI tail past 64 is zero-filled by TMA); W dividing 128 and H a
    multiple of 128 / W (an M tile of 128 pixels is whole rows of one
    image); ``aligned``, i.e. 16-byte-aligned pointers. ``"mma_sync"`` for
    every other bf16 input.
    """
    if dtype == torch.float32:
        return "fma"
    _, h, w, ci = shape_x
    co = shape_w[3]
    whole_rows = (0 < w and WGMMA_TILE_PIXELS % w == 0
                  and h % (WGMMA_TILE_PIXELS // w) == 0)
    if (dtype == torch.bfloat16 and aligned and ci % 8 == 0 and co % 8 == 0
            and whole_rows):
        return "wgmma"
    return "mma_sync"


def _launch(x: torch.Tensor, w: torch.Tensor, path: str) -> torch.Tensor:
    """Launch the kernel of ``path`` on checked CUDA inputs and count it."""
    n, h, wd, ci = x.shape
    co = w.shape[3]
    out = torch.empty(n, h, wd, co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = native.library()
    if path == "wgmma":
        # the weights K-major, (CO, 3, 3, CI): rows of the B tiles
        wk = w.permute(3, 0, 1, 2).contiguous()
        code = lib.marconet_conv3x3_wgmma(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h, wd, ci, co,
            stream)
    elif path == "fma":
        code = lib.marconet_conv3x3_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, ci, co,
            stream)
    else:
        code = lib.marconet_conv3x3_same(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, ci, co,
            native.DTYPE_CODES[x.dtype], stream)
    native.check(code, f"conv3x3_same ({path})")
    conv3x3_same.launches += 1
    conv3x3_same.launches_by_path[path] += 1
    return out


def _check_cuda(x: torch.Tensor, w: torch.Tensor) -> None:
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    if x.dtype not in native.DTYPE_CODES:
        raise ValueError(f"conv3x3_same: unsupported dtype {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_same: x (NHWC) and w (HWIO) must be "
                         "contiguous")
    native.require_hopper(x.device)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 zero-SAME convolution, NHWC / HWIO, stride 1, no bias.

    Args:
      x: (N, H, W, CI) contiguous, float32 or bfloat16.
      w: (3, 3, CI, CO) contiguous, ``x``'s dtype and device.
    Returns:
      a new (N, H, W, CO) tensor in ``x``'s dtype, without autograd (K3 is
      forward-only). CPU tensors take :func:`conv3x3_same_plain`; CUDA
      tensors launch the kernel :func:`conv3x3_path` picks (counted in
      ``conv3x3_same.launches`` and ``launches_by_path``) and raise on any
      other dtype, a non-contiguous input or a card other than Hopper.
    """
    _check(x, w)
    if x.device.type == "cpu":
        with torch.no_grad():
            return conv3x3_same_plain(x, w)
    _check_cuda(x, w)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return _launch(x, w, conv3x3_path(tuple(x.shape), tuple(w.shape),
                                      x.dtype, aligned))


def _conv3x3_mma_sync(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The general bf16 kernel on any bf16 CUDA input, whatever the rule
    picks: the design ``"wgmma"`` replaced for the SFT shapes, kept for
    comparing the two on the same inputs. Raises for f32, which only
    ``"fma"`` computes."""
    _check_cuda(x, w)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"_conv3x3_mma_sync: the mma.sync kernel is bf16 "
                         f"only; got {x.dtype}")
    return _launch(x, w, "mma_sync")


conv3x3_same.launches = 0
conv3x3_same.launches_by_path = {"wgmma": 0, "mma_sync": 0, "fma": 0}
