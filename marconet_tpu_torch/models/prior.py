"""Structure-prior generator: character-codebook StyleGAN.

Counterpart of ``marconet_tpu/models/prior.py`` (reference ``TSPGAN`` /
``TextGenerator``, ``models/networks.py:51-164``), 27.97 M parameters at
full width. Given a style vector ``w`` and one label per row, it renders a
128 x 128 glyph prior plus the 64 x 64 and 32 x 32 features the SR net's
SFT fusion consumes. Kept from the reference: no noise injection,
bilinear upsampling, tanh in every ToRGB, and the style MLP (PixelNorm +
8 x EqualLinear(lr_mul=0.01, fused LeakyReLU)).

Module names follow ``net_prior_generation.pth`` (``TextGenerator.*``).
Outputs are NCHW in channels_last memory format.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from marconet_tpu_torch.models.encoder import scaled_width
from marconet_tpu_torch.ops.layers import EqualLinear, PixelNorm, Precision
from marconet_tpu_torch.ops.modconv import StyledConv, ToRGB

# channel plan per resolution (channel_multiplier=1)
_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128}
_PYRAMID = (8, 16, 32, 64, 128)


def channel_plan(width: float) -> dict:
    """Per-resolution channels scaled by ``width`` (1.0 = exact)."""
    return {r: scaled_width(c, width, floor=16) for r, c in _CHANNELS.items()}


class PriorOutput(NamedTuple):
    image: torch.Tensor    # (B, 3, 128, 128) tanh'd RGB
    feat64: torch.Tensor   # (B, C64, 64, 64)
    feat32: torch.Tensor   # (B, C32, 32, 32)
    rgb64: torch.Tensor    # (B, 3, 64, 64)
    rgb32: torch.Tensor    # (B, 3, 32, 32)


class CharCodebook(nn.Module):
    """Per-character learned 4 x 4 constant inputs.

    ``TextEmbeddings`` (classes, C, 1, 1); each label's embedding is
    broadcast over its 4 x 4 cell.
    """

    def __init__(self, num_classes: int, channels: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.TextEmbeddings = nn.Parameter(torch.empty(
            num_classes, channels, 1, 1, device=device))
        with torch.no_grad():
            self.TextEmbeddings.normal_(generator=generator)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        """labels (B,) int -> (B, C, 4, 4) channels_last."""
        x = self.TextEmbeddings[labels].expand(-1, -1, 4, 4)
        return x.contiguous(memory_format=torch.channels_last)


class TextGenerator(Precision, nn.Module):
    """Style MLP + codebook + modulated conv pyramid (4 -> 128); the
    codebook's f32 embeddings enter the pyramid in ``dtype``."""

    def __init__(self, num_classes: int, style_dim: int, channels: dict, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        ch = channels
        kw = dict(device=device, generator=generator)
        self.style_mlp = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=0.01,
                        activation="fused_lrelu", **kw)
            for _ in range(8)])
        self.input_text = CharCodebook(num_classes, ch[4], **kw)
        self.conv1 = StyledConv(ch[4], ch[4], style_dim, **kw)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample=False, **kw)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        cin = ch[4]
        for res in _PYRAMID:
            self.convs.append(StyledConv(cin, ch[res], style_dim,
                                         upsample=True, **kw))
            self.convs.append(StyledConv(ch[res], ch[res], style_dim, **kw))
            self.to_rgbs.append(ToRGB(ch[res], style_dim, **kw))
            cin = ch[res]

    def forward(self, styles: torch.Tensor, labels: torch.Tensor
                ) -> PriorOutput:
        """styles (B, style_dim); labels (B,) int."""
        w = self.style_mlp(styles)
        x = self.input_text(labels).to(self.dtype)
        x = self.conv1(x, w)
        skip = self.to_rgb1(x, w)
        feats = {}
        for i, res in enumerate(_PYRAMID):
            x = self.convs[2 * i](x, w)
            x = self.convs[2 * i + 1](x, w)
            skip = self.to_rgbs[i](x, w, skip)
            feats[res] = (x, skip)
        return PriorOutput(skip, feats[64][0], feats[32][0], feats[64][1],
                           feats[32][1])


class StructurePriorGenerator(nn.Module):
    """The reference's ``TSPGAN``: wraps ``TextGenerator``."""

    def __init__(self, num_classes: int = 6736, style_dim: int = 512,
                 width: float = 1.0, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.channels = channel_plan(width)
        self.TextGenerator = TextGenerator(
            num_classes, style_dim, self.channels, device=device,
            generator=generator)

    def forward(self, styles: torch.Tensor, labels: torch.Tensor
                ) -> PriorOutput:
        return self.TextGenerator(styles, labels)
