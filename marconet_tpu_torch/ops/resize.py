"""x2 bilinear upsample with torch ``F.interpolate`` semantics.

Counterpart of ``marconet_tpu/ops/resize.py::upsample2x_bilinear``: every
in-graph resize of the reference networks is a x2 bilinear upsample with
half-pixel centers (``align_corners=False``). The JAX package's composed
upsample-conv is a TPU rewrite; the port upsamples, then convolves, which
is the exact composition.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of an NCHW tensor, half-pixel centers."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)
