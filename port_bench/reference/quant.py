"""Operand roundings for the controls of the correctness check.

A control is the reference computed one precision below the one that its
configuration states: float8 (e4m3, per-tensor amax scaling, the usual
fp8 recipe) for a configuration that computes in bfloat16, TF32 for one
that computes in IEEE float32. Each operand of every matrix product is
rounded; the products sum in float32, as the tensor cores sum them.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, returned in
    its own dtype."""
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 ``t`` rounded to TF32 (10 mantissa bits, to nearest
    even), as the tensor cores take their operands."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _through(rounding):
    """``rounding`` with its gradient passed straight through, so a
    training control differentiates the rounded forward."""
    def apply(t: torch.Tensor) -> torch.Tensor:
        r = rounding(t.detach())
        return r if not t.requires_grad else t + (r - t.detach())
    return apply


ROUNDINGS = {name: _through(f) for name, f in
             (("fp8", fp8), ("tf32", tf32))}
