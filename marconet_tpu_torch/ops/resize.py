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


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of an NCHW tensor, half-pixel centers."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size`` (H, W), half-pixel
    centers, antialiased when shrinking: ``jax.image.resize``'s
    ``"bilinear"`` (a triangle filter widened by the shrink factor), which
    ``F.interpolate(..., antialias=True)`` computes too."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)
