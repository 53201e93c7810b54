"""Fixed-width window gathers and the 2-tap width resample (counterpart
of ``marconet_tpu/ops/window.py``).

Starts are clamped into ``[0, Wp - win]`` exactly as ``jax.lax.
dynamic_slice`` clamps them. Each op is its plain forward gather; torch
autograd transposes it into an index scatter-add on any device. The JAX
package's custom VJPs (one-hot scatter-add matmuls) were TPU rewrites of
those transposes and have no counterpart here.
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


def resample2tap(img: torch.Tensor, idx: torch.Tensor,
                 w0: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), idx / w0 (B, N, K) -> (B, N, H, K, C).

    ``out[b, n, h, k] = w0 * img[b, h, idx] + (1 - w0) * img[b, h, idx+1]``
    with ``idx + 1`` clamped to ``W - 1``: the fixed-shape crop-and-resize
    of the training char crops (JAX ``ops/window.py:139-189``).
    """
    b, h, w, _ = img.shape
    dev = img.device
    i0 = idx.long()                                          # (B, N, K)
    i1 = (i0 + 1).clamp(max=w - 1)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi = torch.arange(h, device=dev)[None, None, :, None]
    a = img[bi, hi, i0[:, :, None, :]]                       # (B,N,H,K,C)
    c = img[bi, hi, i1[:, :, None, :]]
    wt = w0[:, :, None, :, None].to(img.dtype)
    return a * wt + c * (1.0 - wt)
