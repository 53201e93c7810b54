"""ConvNeXt + ViT CTC line recognizer (counterpart of
``marconet_tpu/models/convnext_ocr.py``, ModelScope ``ConvNextViT``).

The reference recognizes masked character segments with ModelScope's
``damo/cv_convnextTiny_ocr-recognition-general_damo``: a ConvNeXt trunk
that keeps the width resolution (stem stride 4, then height-only (2, 1)
downsampling, so a (32, W) line gives W / 4 frames), a ViT encoder over
the frames and a per-frame CTC head over its own vocabulary.

Modules carry the ModelScope export's key names without their uniform
prefix (public ConvNeXt ``downsample_layers`` / ``stages``, timm ViT
``blocks``); :func:`marconet_tpu_torch.convert.load_ocr_checkpoint`
strips the prefix, derives the :class:`OCRConfig` from the shapes and
loads strictly. No TPU kernel is on this path. Tensors inside the trunk
are NCHW in ``channels_last``; the public input is NHWC like the JAX
module's.

One deviation: the JAX module declares a weight-free model's positional
embedding at the length of its first input (``seq_len=None``); a torch
module's parameters exist before any input, so :class:`ConvNextViT`
needs ``OCRConfig.seq_len`` and interpolates the embedding to other
lengths, as the JAX module does for a loaded checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.alphabet import NUM_CLASSES, alphabet
from marconet_tpu_torch.ops.layers import Conv, Linear, lecun_normal_

LN_EPS = 1e-6


@dataclass(frozen=True)
class OCRConfig:
    """Topology of the ConvNextViT recognizer.

    Defaults are ConvNeXt-T (3, 3, 9, 3) x (96 ... 768) and 12 ViT blocks
    of width 768 over the alphabet + 1 classes; a loaded checkpoint sets
    every field from its shapes. ``seq_len`` is the positional embedding's
    length (including the cls token): :attr:`canonical_width` is the input
    width that matches it exactly.
    """

    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    vit_depth: int = 12
    vit_dim: int = 768
    vit_heads: int = 12
    vit_mlp_ratio: float = 4.0
    num_classes: int = NUM_CLASSES         # alphabet + CTC blank
    blank_index: int = 0                   # ModelScope's CTC blank is id 0
    use_cls_token: bool = False
    use_vit_proj: Optional[bool] = None    # None: project iff dims differ
    cnn_final_norm: bool = False
    layer_scale_init: float = 1e-6
    seq_len: Optional[int] = None

    @property
    def canonical_width(self) -> Optional[int]:
        """Input width whose token count is ``seq_len`` (W / 4 frames plus
        the optional cls token)."""
        if self.seq_len is None:
            return None
        return 4 * (self.seq_len - (1 if self.use_cls_token else 0))

    @property
    def project(self) -> bool:
        if self.use_vit_proj is not None:
            return self.use_vit_proj
        return self.vit_dim != self.dims[-1]


class ChannelLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the channels of an NCHW tensor (ConvNeXt's
    ``channels_first`` LayerNorm)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__(channels, eps=LN_EPS, device=device)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv -> LayerNorm -> pointwise MLP (GELU) -> layer
    scale, residual."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.dwconv = nn.Module()
        self.dwconv.weight = nn.Parameter(torch.empty(dim, 1, 7, 7,
                                                      device=device))
        lecun_normal_(self.dwconv.weight, 49, generator)
        self.dwconv.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        kw = dict(device=device, generator=generator)
        self.pwconv1 = Linear(dim, 4 * dim, **kw)
        self.pwconv2 = Linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init,
                                             device=device)) \
            if layer_scale_init > 0 else None

    def forward(self, x):
        y = F.conv2d(x, self.dwconv.weight, self.dwconv.bias, padding=3,
                     groups=x.shape[1]).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y.permute(0, 3, 1, 2)


def resize_pos_embed(pos: torch.Tensor, n_tokens: int,
                     use_cls_token: bool) -> torch.Tensor:
    """A (1, L, D) positional embedding at ``n_tokens`` entries: linear
    interpolation with half-pixel centres, the kernel widened when
    shrinking (``jax.image.resize(..., "linear")``, antialiased), the cls
    slot kept as it is. Identity when the lengths already match."""
    if pos.shape[1] == n_tokens:
        return pos
    cls_part = None
    if use_cls_token:
        cls_part, pos = pos[:, :1], pos[:, 1:]
        n_tokens -= 1
    n_in = pos.shape[1]
    scale = np.float32(n_tokens / n_in)
    kernel_scale = max(np.float32(1) / scale, np.float32(1))
    sample = ((np.arange(n_tokens, dtype=np.float32) + np.float32(0.5))
              / scale - np.float32(0.5))
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
                  ) / np.float32(kernel_scale)
    w = np.maximum(np.float32(0), np.float32(1) - dist)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    out = torch.einsum("bld,ln->bnd", pos,
                       torch.from_numpy(w).to(device=pos.device,
                                              dtype=pos.dtype))
    if cls_part is not None:
        out = torch.cat([cls_part, out], dim=1)
    return out


class Attention(nn.Module):
    """timm ``Attention``: fused qkv with biases, softmax in f32."""

    def __init__(self, dim: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)

    def forward(self, x):
        b, n, d = x.shape
        h = self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d // h).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = torch.softmax((q.float() @ k.float().transpose(-2, -1))
                             * ((d // h) ** -0.5), dim=-1).to(v.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = Linear(dim, hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm ViT encoder block (timm ``Block`` keys)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = Attention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ConvNextViT(nn.Module):
    """ConvNeXt trunk -> frame sequence -> ViT encoder -> CTC logits.

    Input (B, 32, W, 3) NHWC in [-1, 1] (``(x / 255 - 0.5) / 0.5``, as
    ``CharacterFrontend`` normalizes); output (B, W / 4, num_classes).
    """

    def __init__(self, config: OCRConfig, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        cfg = self.config = config
        if cfg.seq_len is None:
            raise ValueError("ConvNextViT needs OCRConfig.seq_len (the "
                             "positional embedding's length)")
        kw = dict(device=device, generator=generator)
        dims = cfg.dims
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            Conv(3, dims[0], 4, stride=4, **kw),
            ChannelLayerNorm(dims[0], device=device))])
        for i in range(1, len(dims)):
            self.downsample_layers.append(nn.Sequential(
                ChannelLayerNorm(dims[i - 1], device=device),
                Conv(dims[i - 1], dims[i], (2, 1), stride=(2, 1), **kw)))
        self.stages = nn.ModuleList(nn.Sequential(*(
            ConvNeXtBlock(dim, cfg.layer_scale_init, **kw)
            for _ in range(depth))) for depth, dim in zip(cfg.depths, dims))
        if cfg.cnn_final_norm:
            self.cnn_norm = nn.LayerNorm(dims[-1], eps=LN_EPS, device=device)
        if cfg.project:
            self.patch_embed = nn.Module()
            self.patch_embed.proj = Linear(dims[-1], cfg.vit_dim, **kw)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.vit_dim,
                                                      device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len,
                                                  cfg.vit_dim, device=device))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.vit_dim, cfg.vit_heads, cfg.vit_mlp_ratio, **kw)
            for _ in range(cfg.vit_depth))
        self.norm = nn.LayerNorm(cfg.vit_dim, eps=LN_EPS, device=device)
        self.head = Linear(cfg.vit_dim, cfg.num_classes, **kw)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
        seq = (x.mean(dim=2) if x.shape[2] > 1 else x[:, :, 0]) \
            .transpose(1, 2)                                # (B, W/4, C)
        if cfg.cnn_final_norm:
            seq = self.cnn_norm(seq)
        if cfg.project:
            seq = self.patch_embed.proj(seq)
        if cfg.use_cls_token:
            seq = torch.cat([self.cls_token.expand(seq.shape[0], -1, -1),
                             seq], dim=1)
        seq = seq + resize_pos_embed(self.pos_embed, seq.shape[1],
                                     cfg.use_cls_token)
        for block in self.blocks:
            seq = block(seq)
        seq = self.norm(seq)
        if cfg.use_cls_token:
            seq = seq[:, 1:]
        return self.head(seq)


def ConvNeXtOCR(num_classes: int = NUM_CLASSES, *, seq_len: int,
                device=None, generator: torch.Generator,
                **cfg_kw) -> ConvNextViT:
    """Weight-free recognizer over the MARCONet alphabet (blank last, like
    the core models' class 6735)."""
    return ConvNextViT(OCRConfig(num_classes=num_classes,
                                 blank_index=num_classes - 1,
                                 seq_len=seq_len, **cfg_kw),
                       device=device, generator=generator)


def decode_ctc_ids(ids, charset: Optional[str] = None, blank: int = 0,
                   offset: int = 0) -> List[str]:
    """Greedy CTC decode of per-frame argmax ids (B, T) into strings:
    repeats and the blank dropped, id ``offset + i`` -> ``charset[i]``
    (default: the alphabet)."""
    charset = alphabet() if charset is None else charset
    out = []
    for seq in np.asarray(ids):
        chars, prev = [], -1
        for t in seq:
            ci = int(t) - offset
            if t != prev and t != blank and 0 <= ci < len(charset):
                chars.append(charset[ci])
            prev = t
        out.append("".join(chars))
    return out


def decode_ctc(logits, charset: Optional[str] = None,
               blank: Optional[int] = None, offset: int = 0) -> List[str]:
    """Greedy CTC decode of (B, T, C) logits; ``blank`` defaults to the
    last class without an offset, else to 0 (ModelScope's)."""
    arr = np.asarray(logits)
    if blank is None:
        blank = arr.shape[-1] - 1 if offset == 0 else 0
    return decode_ctc_ids(arr.argmax(-1), charset=charset, blank=blank,
                          offset=offset)
