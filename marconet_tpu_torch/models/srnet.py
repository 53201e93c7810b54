"""Structure-prior SR network: x4 text-line super-resolution with
per-character SFT (spatial feature transform) fusion.

Counterpart of ``marconet_tpu/models/srnet.py`` (reference ``TSPSRNet``,
``models/networks.py:328-485``), 16.87 M parameters at full width, in the
plain forms that the JAX package's CPU suite pins:

* each character slot cuts a constant-width window (``2 * half_width``)
  from the canvas right-padded by ``half_width`` (the padded gather), so
  window column j is canvas column x1 + j;
* truncated edge windows are handled with a column-validity mask: convs
  see zeros beyond the valid columns and GroupNorm / AdaIN statistics are
  taken over valid columns only;
* all B x N windows run through the conv stacks as one batch;
* the write-back keeps the reference's last-writer-wins overlap through
  kernel K2 (``ops/sft_writeback``).

Module names follow ``net_sr.pth``. Tensors are NCHW, channels_last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.layers import (
    ResTextBlockV2,
    SNConv,
    adaptive_instance_norm,
    nchw,
    nhwc,
)
from marconet_tpu_torch.ops.resize import Upsample2x, upsample2x_bilinear
from marconet_tpu_torch.ops.sft_writeback import sft_writeback
from marconet_tpu_torch.ops.window import (
    gather_windows,
    gather_windows_per_slot,
)


class SNStack(nn.Sequential):
    """SNConv -> LeakyReLU(0.2) -> SNConv (keys ``.0`` and ``.2``), with the
    column mask applied after each conv."""

    def __init__(self, in_ch: int, out_ch: int, *, device=None,
                 generator: torch.Generator):
        super().__init__(
            SNConv(in_ch, out_ch, device=device, generator=generator),
            nn.LeakyReLU(0.2),
            SNConv(out_ch, out_ch, device=device, generator=generator))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = self[0](x)
        if mask is not None:
            x = x * mask.to(x.dtype)
        x = self[2](self[1](x))
        if mask is not None:
            x = x * mask.to(x.dtype)
        return x


def window_geometry(locs: torch.Tensor, half_width: int, width: int):
    """Window geometry of every slot at one scale.

    Args:
      locs: (B, 2N) normalized (center, half-width) pairs; the predicted
        half-width is ignored, as in the reference.
      half_width: 16 at the 32-high scale, 32 at the 64-high scale.
      width: canvas width at this scale (512 or 1024).
    Returns:
      x1 (B, N) int32 window starts, L (B, N) valid lengths, y1 (B, N)
      prior-crop starts.
    """
    centers = locs[:, 0::2].float()
    center = torch.floor(centers * width).to(torch.int32)
    x1 = (center - half_width).clamp(min=0)
    x2 = torch.maximum((center + half_width).clamp(max=width), x1)
    length = x2 - x1
    y1 = half_width - torch.div(length, 2, rounding_mode="floor")
    return x1, length, y1


def sft_fusion(canvas, priors, locs, char_mask, *, half_width: int,
               fuse: ResTextBlockV2, scale: SNStack, shift: SNStack):
    """One scale of per-character SFT fusion (batched, masked).

    Args:
      canvas: (B, C, H, W) LQ feature canvas, channels_last.
      priors: (B*N, C, H, 2*half_width) per-slot prior features.
      locs: (B, 2N) normalized (center, half-width) pairs.
      char_mask: (B, N) slot validity.
      fuse, scale, shift: the scale's ``conv_*_fuse.0``, ``conv_*_scale``
        and ``conv_*_shift`` modules.
    Returns:
      canvas + residual with the reference's overlap semantics.
    """
    b, c, h, width = canvas.shape
    n = char_mask.shape[1]
    hw = half_width
    win = 2 * hw
    x1, length, y1 = window_geometry(locs, hw, width)

    # column-validity mask (B*N, 1, 1, win)
    cols = torch.arange(win, device=canvas.device)
    m = (cols < length[:, :, None]).to(canvas.dtype).reshape(b * n, 1, 1, win)

    def flat(t):        # (B, N, H, win, C) -> (B*N, C, H, win) channels_last
        return nchw(t.reshape(b * n, h, win, c))

    # (B, H, W, C); contiguous for K2 (a no-op for a channels_last canvas)
    canvas_h = nhwc(canvas).contiguous()
    # x1 + win <= W + hw: the right pad keeps every window in range
    lq_win = gather_windows(F.pad(canvas_h, (0, 0, 0, hw)), x1, win)
    prior_h = nhwc(priors).reshape(b, n, h, win, c)
    prior_win = gather_windows_per_slot(
        F.pad(prior_h, (0, 0, 0, hw)), y1, win)
    lq_f = flat(lq_win) * m
    prior_f = flat(prior_win) * m

    adain = adaptive_instance_norm(prior_f, lq_f, prior_mask=m, lq_mask=m)
    fused = fuse(torch.cat([adain, lq_f], dim=1), mask=m)
    out_win = lq_f * scale(fused, mask=m) + shift(fused, mask=m)

    res = nhwc(out_win).reshape(b, n, h, win, c)
    valid = (char_mask > 0).to(torch.int32)
    out = sft_writeback(canvas_h, res, x1, length, valid)
    return nchw(out)


class StructurePriorSRNet(nn.Module):
    """The reference's ``TSPSRNet``: encoder/decoder + 2-scale SFT fusion.

    ``dim`` is the SFT feature width (256 at full width; the prior's
    64 x 64 features have this many channels) and ``prior_channels`` the
    prior's 32 x 32 feature width (512 at full width).
    """

    def __init__(self, dim: int = 256, prior_channels: int = 512, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        d = dim
        kw = dict(device=device, generator=generator)

        def sn(ci, co, stride=1):
            return SNConv(ci, co, stride=stride, **kw)

        def lrelu():
            return nn.LeakyReLU(0.2)

        def up():
            return Upsample2x()

        self.conv_first_32 = nn.Sequential(sn(3, d // 4), lrelu())
        self.conv_first_16 = nn.Sequential(sn(d // 4, d // 2, 2), lrelu())
        self.conv_first_8 = nn.Sequential(sn(d // 2, d, 2), lrelu(),
                                          sn(d, d))
        self.conv_body_16 = nn.Sequential(sn(d + d // 2, d), lrelu(),
                                          sn(d, d))
        self.conv_body_32 = nn.Sequential(sn(d + d // 4, d), lrelu(),
                                          sn(d, d))
        self.conv_32_to256 = SNStack(prior_channels, d, **kw)
        for s in (32, 64):
            setattr(self, f"conv_{s}_fuse",
                    nn.Sequential(ResTextBlockV2(2 * d, d, **kw)))
            setattr(self, f"conv_{s}_scale", SNStack(d, d, **kw))
            setattr(self, f"conv_{s}_shift", SNStack(d, d, **kw))
        self.conv_up = nn.Sequential(up(), sn(d, d), lrelu(),
                                     ResTextBlockV2(d, d, **kw), sn(d, d))
        self.conv_final = nn.Sequential(
            sn(d, d // 2), lrelu(), up(), sn(d // 2, d // 4),
            lrelu(), ResTextBlockV2(d // 4, d // 4, **kw), sn(d // 4, 3),
            nn.Tanh())

    def _sft(self, scale: int, canvas, priors, locs, char_mask):
        return sft_fusion(canvas, priors, locs, char_mask,
                          half_width=scale // 2,
                          fuse=getattr(self, f"conv_{scale}_fuse")[0],
                          scale=getattr(self, f"conv_{scale}_scale"),
                          shift=getattr(self, f"conv_{scale}_shift"))

    def forward(self, lq, prior64, prior32, locs, char_mask):
        """
        Args:
          lq: (B, 3, 32, 512) channels_last, in [-1, 1].
          prior64: (B*N, dim, 64, 64) per-slot prior features.
          prior32: (B*N, prior_channels, 32, 32) per-slot prior features.
          locs: (B, 2N) normalized (center, half-width) pairs.
          char_mask: (B, N) slot validity.
        Returns:
          (B, 3, 128, 2048) x4 SR output in [-1, 1], channels_last.
        """
        f32 = self.conv_first_32(lq)
        f16 = self.conv_first_16(f32)
        f8 = self.conv_first_8(f16)
        s16 = self.conv_body_16(torch.cat([upsample2x_bilinear(f8), f16], 1))
        s32 = self.conv_body_32(torch.cat([upsample2x_bilinear(s16), f32],
                                          1))
        s32 = self._sft(32, s32, self.conv_32_to256(prior32), locs,
                        char_mask)
        s64 = self._sft(64, self.conv_up(s32), prior64, locs, char_mask)
        return self.conv_final(s64)
