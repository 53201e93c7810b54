"""Fixed-width window gathers (counterpart of ``marconet_tpu/ops/window.py``,
forward only).

Starts are clamped into ``[0, Wp - win]`` exactly as ``jax.lax.
dynamic_slice`` clamps them. The JAX package's custom VJPs (one-hot
scatter-add matmuls) were TPU rewrites of the gathers' transposes; the
port has no training path yet, and torch autograd would transpose these
gathers itself.
"""

from __future__ import annotations

import torch


def _columns(starts: torch.Tensor, wp: int, win: int) -> torch.Tensor:
    starts = starts.long().clamp(0, wp - win)
    return starts[:, :, None, None] + torch.arange(win, device=starts.device)


def gather_windows(canvas: torch.Tensor, starts: torch.Tensor,
                   win: int) -> torch.Tensor:
    """canvas (B, H, Wp, C), starts (B, N) -> (B, N, H, win, C)."""
    b, h, wp, _ = canvas.shape
    dev = canvas.device
    cols = _columns(starts, wp, win)                        # (B, N, 1, win)
    return canvas[torch.arange(b, device=dev)[:, None, None, None],
                  torch.arange(h, device=dev)[None, None, :, None], cols]


def gather_windows_per_slot(t: torch.Tensor, starts: torch.Tensor,
                            win: int) -> torch.Tensor:
    """t (B, N, H, Wp, C), starts (B, N) -> (B, N, H, win, C): slot n
    slices its own plane."""
    b, n, h, wp, _ = t.shape
    dev = t.device
    cols = _columns(starts, wp, win)
    return t[torch.arange(b, device=dev)[:, None, None, None],
             torch.arange(n, device=dev)[None, :, None, None],
             torch.arange(h, device=dev)[None, None, :, None], cols]
