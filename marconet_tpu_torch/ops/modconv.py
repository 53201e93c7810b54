"""StyleGAN2-style modulated convolution (counterpart of
``marconet_tpu/ops/modconv.py``).

Modulation and demodulation are folded into the activations:
``conv(x, scale*W*s[b]*d[b]) == d[b] * conv(x * s[b], scale*W)``, so one
shared-weight conv serves the whole batch (the reference builds per-sample
weights and runs a grouped conv). Quirks kept for checkpoint parity:
bilinear x2 upsampling before the conv (never upfirdn2d), ``StyledConv``
adds its own bias and the activation's bias before the sqrt(2)-scaled
LeakyReLU, and ``ToRGB`` applies tanh to every skip sum.

Parameter names and shapes are the reference's: ``conv.weight``
(1, O, I, k, k), ``conv.modulation.{weight,bias}``, ``bias`` (1, O, 1, 1)
and ``activate.bias`` (O,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.fused_act import FusedLeakyReLU, fused_leaky_relu
from marconet_tpu_torch.ops.layers import (
    EqualLinear,
    Precision,
    equalized_gain,
)
from marconet_tpu_torch.ops.resize import upsample2x_bilinear


class ModulatedConv2d(Precision, nn.Module):
    """Style-modulated conv with activation-folded (de)modulation, in
    ``dtype``: the weight scaled in its own dtype and rounded once, the
    demodulation from the f32 weight, as the JAX package's."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, *, demodulate: bool = True,
                 upsample: bool = False, device=None,
                 generator: torch.Generator):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(1, out_ch, in_ch, k, k,
                                               device=device))
        with torch.no_grad():
            self.weight.normal_(generator=generator)
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      device=device, generator=generator)
        self.scale = equalized_gain(in_ch * k * k)
        self.padding = k // 2
        self.demodulate = demodulate
        self.upsample = upsample

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """x: (B, I, H, W) channels_last; style: (B, style_dim)."""
        s = self.modulation(style)                             # (B, I)
        w = (self.weight[0] * self.scale).to(self.dtype)       # (O, I, k, k)
        x = x.to(self.dtype) * s[:, :, None, None]
        if self.upsample:
            x = upsample2x_bilinear(x)
        y = F.conv2d(x, w, padding=self.padding)
        if self.demodulate:
            # d[b, o] = rsqrt(sum_{i,kh,kw} (scale * W * s[b, i])^2 + 1e-8),
            # in f32
            w2 = (self.weight[0].float() * self.scale).square().sum((2, 3))
            demod = torch.rsqrt(s.float().square() @ w2.T + 1e-8)
            y = y * demod.to(y.dtype)[:, :, None, None]
        return y


class StyledConv(nn.Module):
    """ModulatedConv2d, then both biases and the fused LeakyReLU (K1)."""

    def __init__(self, in_ch: int, out_ch: int, style_dim: int,
                 kernel_size: int = 3, *, upsample: bool = False,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, device=device,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, out_ch, 1, 1,
                                             device=device))
        self.activate = FusedLeakyReLU(out_ch, device=device)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        # K1 reads channels_last; cuDNN's convs keep it (a no-op then),
        # PyTorch's native CUDA convs return NCHW-contiguous
        y = self.conv(x, style).contiguous(memory_format=torch.channels_last)
        # both biases are added (in their dtype) before the activation:
        # one K1 call, which rounds the sum to y's dtype
        return fused_leaky_relu(y, self.bias.view(-1) + self.activate.bias)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB; tanh of every (upsampled) skip sum."""

    def __init__(self, in_ch: int, style_dim: int, *, upsample: bool = True,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    device=device, generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1, device=device))
        self.upsample = upsample

    def forward(self, x, style, skip=None):
        y = self.conv(x, style)
        y = y + self.bias.to(y.dtype)
        if skip is not None:
            if self.upsample:
                skip = upsample2x_bilinear(skip)
            y = y + skip
        return torch.tanh(y)
