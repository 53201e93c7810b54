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
CUDA tensors it launches K3 (``csrc/conv3x3.cu``, counted in
``conv3x3_same.launches``) or raises. The TPU kernel's 256 / 128 channel
blocks were a VMEM tiling rule, not part of the function: both versions
take any CI and CO. K3 is bound by operations; the source says what its
design does about that.
"""

from __future__ import annotations

import torch

from marconet_tpu_torch import native

CI_BLOCK = 256   # the TPU kernel's input-channel block (_KBLK)


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


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 zero-SAME convolution, NHWC / HWIO, stride 1, no bias.

    Args:
      x: (N, H, W, CI) contiguous, float32 or bfloat16.
      w: (3, 3, CI, CO) contiguous, ``x``'s dtype and device.
    Returns:
      a new (N, H, W, CO) tensor in ``x``'s dtype, without autograd (K3 is
      forward-only). CPU tensors take :func:`conv3x3_same_plain`; CUDA
      tensors launch K3 (counted in ``conv3x3_same.launches``) and raise on
      any other dtype, a non-contiguous input or a card other than Hopper.
    """
    _check(x, w)
    if x.device.type == "cpu":
        with torch.no_grad():
            return conv3x3_same_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    code = native.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"conv3x3_same: unsupported dtype {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_same: x (NHWC) and w (HWIO) must be "
                         "contiguous")
    native.require_hopper(x.device)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    out = torch.empty(n, h, wd, co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    native.check(native.library().marconet_conv3x3_same(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, ci, co, code,
        stream), "conv3x3_same")
    conv3x3_same.launches += 1
    return out


conv3x3_same.launches = 0
