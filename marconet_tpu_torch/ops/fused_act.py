"""Fused bias + LeakyReLU(0.2) * sqrt(2): kernel K1 and its plain twin.

Counterpart of ``marconet_tpu/ops/fused_act.py``. The TPU kernel it
replaces is ``_fwd_kernel`` (``marconet_tpu/ops/fused_act.py:48``,
launched by ``_fused_lrelu_fwd``); it is also the reference's only native
op, basicsr's ``fused_act`` CUDA extension.

``y = sqrt(2) * leaky_relu(x + b, 0.2)`` with ``b`` broadcast over the
channel axis, math in f32, stored in ``x``'s dtype.

On a CUDA tensor :func:`fused_leaky_relu` launches the hand-written kernel
``csrc/fused_act.cu``; on a CPU tensor it runs :func:`fused_leaky_relu_plain`.
The kernel is bound by device-memory bytes (one read and one write per
element); see the source for what its design does about that. The backward
(TPU ``_bwd_kernel``) belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from marconet_tpu_torch import native

SQRT2 = math.sqrt(2.0)
NEGATIVE_SLOPE = 0.2


def _channel_count(x: torch.Tensor) -> int:
    """Channel count of a layout the kernel takes, or raise.

    The kernel reads a (rows, C) view whose last physical dimension is the
    channel: a contiguous 2-D tensor, or a 4-D NCHW tensor in
    ``torch.channels_last`` memory format.
    """
    if x.dim() == 2 and x.is_contiguous():
        return x.shape[1]
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[1]
    raise ValueError(
        "fused_leaky_relu takes a contiguous (rows, C) tensor or an NCHW "
        f"tensor in channels_last memory format; got shape "
        f"{tuple(x.shape)} with strides {x.stride()}")


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version: f32 math, one rounding to ``x``'s dtype.

    The bias is first rounded to ``x``'s dtype, as the TPU kernel does.
    """
    b = bias.to(x.dtype).float().reshape((1, -1) + (1,) * (x.dim() - 2))
    v = x.float() + b
    v = torch.where(v >= 0, v, v * NEGATIVE_SLOPE) * SQRT2
    return v.to(x.dtype)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * leaky_relu(x + bias, 0.2)``, bias (C,) on the channels.

    ``x`` is (rows, C) contiguous or NCHW channels_last, f32 or bf16. CPU
    tensors take the plain version; CUDA tensors launch kernel K1 (and
    count the launch in ``fused_leaky_relu.launches``).
    """
    c = _channel_count(x)
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
    code = native.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"fused_leaky_relu: unsupported dtype {x.dtype}")
    if bias.device != x.device:
        raise ValueError("fused_leaky_relu: bias is on another device")
    native.require_hopper(x.device)
    lib = native.library()
    b = bias.to(x.dtype).contiguous()
    y = torch.empty_like(x)  # keeps x's (channels_last) memory format
    stream = torch.cuda.current_stream(x.device).cuda_stream
    native.check(lib.marconet_fused_lrelu_fwd(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, code,
        stream), "fused_leaky_relu")
    fused_leaky_relu.launches += 1
    return y


fused_leaky_relu.launches = 0


class FusedLeakyReLU(nn.Module):
    """basicsr ``FusedLeakyReLU``: owns the activation's bias (``bias``)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)
