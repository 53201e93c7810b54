"""Bilinear resizes.

- ``upsample2x_bilinear``: counterpart of ``marconet_tpu/ops/resize.py::
  upsample2x_bilinear``. Every in-graph resize of the reference networks
  is a x2 bilinear upsample with half-pixel centers
  (``align_corners=False``). The JAX package's composed upsample-conv is a
  TPU rewrite; the port upsamples, then convolves, which is the exact
  composition.
- ``resize_bilinear``: ``jax.image.resize(..., "bilinear")``, which
  antialiases when it shrinks (the trainer's 128 -> 64 and 128 -> 32
  glyph targets, ``marconet_tpu/train/train_step.py:136-141``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# PyTorch's channels_last bilinear upsample on CUDA refuses outputs of
# INT_MAX elements or more (e.g. the prior's 64 x 64 upsample over the
# 1024 slots of 64 lines x 16 characters)
MAX_OUTPUT_ELEMENTS = 2**31 - 1


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of an NCHW tensor, half-pixel centers.

    A batch whose output would reach ``MAX_OUTPUT_ELEMENTS`` runs in
    pieces along the batch, joined in the input's memory format."""
    per_item = 4 * x[0].numel() if x.shape[0] else 1
    step = max(1, MAX_OUTPUT_ELEMENTS // per_item)
    if x.shape[0] <= step:
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)
    return torch.cat([upsample2x_bilinear(x[i:i + step])
                      for i in range(0, x.shape[0], step)])


class Upsample2x(nn.Module):
    """:func:`upsample2x_bilinear` as a module (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_bilinear(x)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` (H, W), half-pixel
    centers, antialiased when shrinking: ``jax.image.resize``'s
    ``"bilinear"`` (a triangle filter widened by the shrink factor), which
    ``F.interpolate(..., antialias=True)`` computes too."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)
