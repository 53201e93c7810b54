"""LPIPS perceptual distance: VGG16 trunk + learned linear heads
(counterpart of ``marconet_tpu/train/lpips.py``).

The ``lpips.LPIPS(net='vgg')`` loss the reference applies to SR patches
(``LPIPSLossF``, ``Train/tspgan/losses/text_loss.py:77-105``): inputs in
[-1, 1] are shifted and scaled, VGG16 features are tapped after relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3, normalized to unit length over the
channels, squared-differenced, reduced by 1x1 "lin" heads and averaged.

Key names are torchvision's (``features.{idx}.*``) and lpips's
(``lin{i}.model.1.weight``), so :func:`load_lpips` reads the
``vgg16-397923af.pth`` and lpips ``vgg.pth`` state dicts straight into the
module. Those files are not in the repository; without them the module
keeps random weights, which is a different objective from the reference's,
so the trainer refuses to train on it unless the caller explicitly allows
it. The module is never trained: its parameters do not require grad.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from marconet_tpu_torch.ops.layers import Conv

# VGG16 conv plan: (channels, convs in block); taps after each block's relu
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# lpips scaling layer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# candidate filenames searched by ``load_lpips`` (as the JAX package)
_VGG_FILES = ("vgg16-397923af.pth", "vgg16.pth", "vgg16_features.pth")
_LIN_FILES = ("lpips_vgg.pth", "lpips_vgg_v0.1.pth", "vgg_lpips.pth",
              "vgg.pth")


class _LinHead(nn.Module):
    """lpips ``NetLinLayer``: key ``model.1.weight`` (index 0 was dropout,
    which the reference's eval-mode loss never applies)."""

    def __init__(self, ch: int, *, device=None, generator: torch.Generator):
        super().__init__()
        self.model = nn.Sequential(
            nn.Identity(), Conv(ch, 1, 1, bias=False, device=device,
                                generator=generator))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """Perceptual distance of two NCHW batches in [-1, 1] -> (B,).

    ``width`` scales the VGG channel plan (1.0 = torchvision's VGG16).
    """

    def __init__(self, width: float = 1.0, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        layers, self._taps, cin = [], [], 3
        for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            ch = max(8, int(round(ch * width)))
            for _ in range(n_convs):
                layers += [Conv(cin, ch, 3, padding=1, **kw),
                           nn.ReLU()]
                cin = ch
            self._taps.append(len(layers) - 1)
            if bi < len(_VGG_BLOCKS) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.channels = [max(8, int(round(ch * width)))
                         for ch, _ in _VGG_BLOCKS]
        for i, ch in enumerate(self.channels):
            setattr(self, f"lin{i}", _LinHead(ch, **kw))
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device)
                             .reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device)
                             .reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def _feats(self, x):
        x = (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x)
        return taps

    def forward(self, pred: torch.Tensor, target: torch.Tensor):
        total = 0.0
        for i, (a, b) in enumerate(zip(self._feats(pred),
                                       self._feats(target))):
            a = a * torch.rsqrt(a.square().sum(1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt(b.square().sum(1, keepdim=True) + 1e-10)
            r = getattr(self, f"lin{i}")((a - b).square())
            total = total + r.mean(dim=(1, 2, 3))
        return total


def load_lpips(module: LPIPS, ckpt_dir: Optional[str]):
    """Load pretrained LPIPS weights from ``ckpt_dir`` into ``module``.

    Looks for torchvision's VGG16 state dict (``vgg16-397923af.pth``) and
    the lpips v0.1 linear heads (``lpips_vgg.pth``, the lpips package's
    ``weights/v0.1/vgg.pth``) and loads both strictly (``module`` must be
    full width). Returns ``module``, or ``None`` when either file is
    absent (the module is then left as it was).
    """
    if not ckpt_dir:
        return None

    def find(names):
        for n in names:
            path = os.path.join(ckpt_dir, n)
            if os.path.exists(path):
                return path
        return None

    vgg_path, lin_path = find(_VGG_FILES), find(_LIN_FILES)
    if vgg_path is None or lin_path is None:
        return None
    vgg = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    state = {}
    for k, v in vgg.items():
        if k.startswith("features."):
            state[k] = v
        elif k.split(".")[0].isdigit():     # a bare ``features`` dict
            state[f"features.{k}"] = v
    state.update({k: v for k, v in lin.items() if k.startswith("lin")})
    module.load_state_dict(state, strict=True)
    return module


class MissingLpipsWeights(ValueError):
    """The pretrained LPIPS weights are absent and a random VGG was not
    allowed."""


def check_lpips_weights(loaded: bool, allow_random: bool) -> None:
    """Refuse a random-VGG perceptual loss unless explicitly allowed
    (the JAX package's ``train/loop.py:150-165``)."""
    if loaded:
        return
    msg = ("LPIPS weights (vgg16-397923af.pth + lpips_vgg.pth) not found")
    if not allow_random:
        raise MissingLpipsWeights(
            msg + ": refusing to train with a random-VGG perceptual loss. "
            "Provide the weights or pass allow_random_lpips=True.")
    print(f"WARNING: {msg}; TRAINING WITH RANDOM VGG WEIGHTS "
          "(allow_random_lpips set)", flush=True)

