"""U-Net discriminator with spectral normalization (counterpart of
``marconet_tpu/train/discriminators.py``).

basicsr's ``UNetDiscriminatorSN`` (``Train/options/train.yml:54-61``):
``net_d`` judges 3-channel glyph / char crops, ``net_srd`` 6-channel
(SR crop, prior glyph) pairs. Three stride-2 4x4 down convs (x2 channels
each), a bilinear x2 up path with skip additions, two 3x3 refinements and
a 1-channel head. conv1..conv8 are spectrally normalized and bias-free;
conv0 and conv9 are plain convs with bias. Key names are basicsr's
(``convN.weight_orig`` / ``weight_u`` / ``weight_v``). Tensors are NCHW,
channels_last.
"""

from __future__ import annotations

import torch
from torch import nn

from marconet_tpu_torch.ops.layers import Conv, SNConv, leaky_relu
from marconet_tpu_torch.ops.resize import upsample2x_bilinear


class UNetDiscriminatorSN(nn.Module):
    """x (B, in_ch, H, W), H and W divisible by 8 -> (B, 1, H, W)."""

    def __init__(self, in_ch: int, num_feat: int = 64, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        f = num_feat
        kw = dict(device=device, generator=generator)

        def sn(ci, co, k, s):
            # every conv here uses torch padding=1 (k is 3 or 4)
            return SNConv(ci, co, k, stride=s, padding=1, bias=False, **kw)

        self.conv0 = Conv(in_ch, f, 3, padding=1, **kw)
        self.conv1 = sn(f, 2 * f, 4, 2)
        self.conv2 = sn(2 * f, 4 * f, 4, 2)
        self.conv3 = sn(4 * f, 8 * f, 4, 2)
        self.conv4 = sn(8 * f, 4 * f, 3, 1)
        self.conv5 = sn(4 * f, 2 * f, 3, 1)
        self.conv6 = sn(2 * f, f, 3, 1)
        self.conv7 = sn(f, f, 3, 1)
        self.conv8 = sn(f, f, 3, 1)
        self.conv9 = Conv(f, 1, 3, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = leaky_relu(self.conv0(x))
        x1 = leaky_relu(self.conv1(x0))
        x2 = leaky_relu(self.conv2(x1))
        x3 = leaky_relu(self.conv3(x2))
        x4 = leaky_relu(self.conv4(upsample2x_bilinear(x3))) + x2
        x5 = leaky_relu(self.conv5(upsample2x_bilinear(x4))) + x1
        x6 = leaky_relu(self.conv6(upsample2x_bilinear(x5))) + x0
        out = leaky_relu(self.conv7(x6))
        out = leaky_relu(self.conv8(out))
        return self.conv9(out)
