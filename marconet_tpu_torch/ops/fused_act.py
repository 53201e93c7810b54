"""Fused bias + LeakyReLU(0.2) * sqrt(2): kernels K1 and K1b, plain twins.

Counterpart of ``marconet_tpu/ops/fused_act.py``. The TPU kernels it
replaces are ``_fwd_kernel`` (``marconet_tpu/ops/fused_act.py:48``,
launched by ``_fused_lrelu_fwd``) and ``_bwd_kernel`` (``:55``, launched
by ``_fused_lrelu_bwd`` inside the custom VJP); the pair is also the
reference's only native op, basicsr's ``fused_act`` CUDA extension.

Forward: ``y = sqrt(2) * leaky_relu(x + b, 0.2)`` with ``b`` broadcast
over the channel axis, math in f32, stored in ``x``'s dtype.
Backward: ``dx = g * (sqrt(2) if x + b >= 0 else 0.2 * sqrt(2))``, f32
math and one rounding to ``x``'s dtype, in the JAX kernel's order;
``db`` is the f32 sum of ``dx`` over every non-channel axis, rounded to
``x``'s dtype and returned in the bias's dtype: the bias may be an f32
parameter with a bf16 ``x``, and the JAX package rounds it to ``x``'s
dtype before its kernel (``bias.astype(dtype)``), so its f32 gradient is
the bf16 ``db`` cast back.

:func:`fused_leaky_relu` is a ``torch.autograd.Function``. On CUDA
tensors its forward launches K1 and its backward K1b (``csrc/
fused_act.cu``); on CPU tensors both directions run the plain twins
:func:`fused_leaky_relu_plain` / :func:`fused_leaky_relu_bwd_plain`. Both
kernels are bound by device-memory bytes; the source says what the design
does about that.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from marconet_tpu_torch import native

SQRT2 = math.sqrt(2.0)
NEGATIVE_SLOPE = 0.2


def _channel_count(x: torch.Tensor) -> int:
    """Channel count of a layout the kernels take, or raise.

    The kernels read a (rows, C) view whose last physical dimension is the
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


def _channel_bias(bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The bias rounded to ``x``'s dtype (as the TPU kernel does), in f32,
    shaped to broadcast over ``x``'s channel axis."""
    return bias.to(x.dtype).float().reshape((1, -1) + (1,) * (x.dim() - 2))


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch forward: f32 math, one rounding to ``x``'s dtype."""
    v = x.float() + _channel_bias(bias, x)
    v = torch.where(v >= 0, v, v * NEGATIVE_SLOPE) * SQRT2
    return v.to(x.dtype)


def fused_leaky_relu_bwd_plain(x: torch.Tensor, bias: torch.Tensor,
                               grad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``dx``: the gain picked from the sign of ``x + b``
    times ``g``, f32 math, one rounding to ``x``'s dtype."""
    v = x.float() + _channel_bias(bias, x)
    gain = torch.where(v >= 0, SQRT2, NEGATIVE_SLOPE * SQRT2)   # f32
    return (gain * grad.float()).to(x.dtype)


def _check_cuda(x: torch.Tensor, bias: torch.Tensor, what: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    code = native.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if bias.device != x.device:
        raise ValueError(f"{what}: bias is on another device")
    native.require_hopper(x.device)
    return code


def _k1(x: torch.Tensor, bias: torch.Tensor, c: int) -> torch.Tensor:
    code = _check_cuda(x, bias, "fused_leaky_relu")
    b = bias.to(x.dtype).contiguous()
    y = torch.empty_like(x)  # keeps x's (channels_last) memory format
    stream = torch.cuda.current_stream(x.device).cuda_stream
    native.check(native.library().marconet_fused_lrelu_fwd(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, code,
        stream), "fused_leaky_relu")
    fused_leaky_relu.launches += 1
    return y


def fused_leaky_relu_bwd(x: torch.Tensor, bias: torch.Tensor,
                         grad: torch.Tensor) -> torch.Tensor:
    """``dx`` of :func:`fused_leaky_relu` for the cotangent ``grad``.

    ``x`` and ``grad`` share shape, dtype and layout ((rows, C) contiguous
    or NCHW channels_last). CPU tensors take
    :func:`fused_leaky_relu_bwd_plain`; CUDA tensors launch kernel K1b
    (counted in ``fused_leaky_relu_bwd.launches``). K1b walks the rows as
    K1 does, a 16-byte pack of channels a thread (a pack of one element
    where C or a pointer does not allow 16 bytes): its earlier scalar
    loop, a 64-bit ``i % C`` and 2-byte accesses per element, ran bf16 at
    its f32 time, 42% of its bound.
    """
    c = _channel_count(x)
    if grad.dtype != x.dtype or grad.shape != x.shape:
        raise ValueError("fused_leaky_relu_bwd: grad must share x's dtype "
                         "and shape")
    _channel_count(grad)
    if x.device.type == "cpu":
        return fused_leaky_relu_bwd_plain(x, bias, grad)
    code = _check_cuda(x, bias, "fused_leaky_relu_bwd")
    b = bias.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    native.check(native.library().marconet_fused_lrelu_bwd(
        x.data_ptr(), b.data_ptr(), grad.data_ptr(), dx.data_ptr(),
        x.numel(), c, code, stream), "fused_leaky_relu_bwd")
    fused_leaky_relu_bwd.launches += 1
    return dx


fused_leaky_relu_bwd.launches = 0


class _FusedLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        c = _channel_count(x)
        if bias.shape != (c,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
        ctx.save_for_backward(x, bias)
        if x.device.type == "cpu":
            return fused_leaky_relu_plain(x, bias)
        return _k1(x, bias, c)

    @staticmethod
    def backward(ctx, grad):
        x, bias = ctx.saved_tensors
        # autograd hands over any layout; the kernel reads x's
        grad = grad.to(x.dtype)
        if x.dim() == 4:
            grad = grad.contiguous(memory_format=torch.channels_last)
        else:
            grad = grad.contiguous()
        dx = fused_leaky_relu_bwd(x, bias, grad)
        db = None
        if ctx.needs_input_grad[1]:
            axes = (0,) if x.dim() == 2 else (0, 2, 3)
            db = dx.float().sum(dim=axes).to(x.dtype).to(bias.dtype)
        return dx, db


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * leaky_relu(x + bias, 0.2)``, bias (C,) on the channels.

    ``x`` is (rows, C) contiguous or NCHW channels_last, f32 or bf16;
    ``bias`` any float dtype (an f32 parameter with a bf16 ``x`` is
    rounded to bf16 first, as the JAX package does). Differentiable in
    ``x`` and ``bias``: the backward is :func:`fused_leaky_relu_bwd`. CPU
    tensors take the plain twins; CUDA tensors launch K1 (counted in
    ``fused_leaky_relu.launches``).
    """
    return _FusedLeakyReLU.apply(x, bias)


fused_leaky_relu.launches = 0


class FusedLeakyReLU(nn.Module):
    """basicsr ``FusedLeakyReLU``: owns the activation's bias (``bias``)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)
