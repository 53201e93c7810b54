"""Text context encoder: ResNet-45 backbone + three-branch ViT head.

Counterpart of ``marconet_tpu/models/encoder.py`` (reference
``TextContextEncoderV2``: ``models/networks.py:27-45``, ``models/resnet.py``,
``models/textvit_arch.py``), 43,062,275 parameters at full width. Module
names follow the reference checkpoint's keys (``resnet.*``,
``transformer.*``), so ``net_transformer_encoder.pth`` loads strictly.

I/O: lq (B, 3, 32, 512) NCHW -> logits (B, 64, 6736), locs (B, 32),
w (B, 512). Attention is the plain matmul-softmax-matmul of the JAX
package: the logits summed in f32 from the compute-dtype q and k, softmax
in f32, the weights rounded to v's dtype. LayerNorms compute in f32 and
round their output to the compute dtype, as flax's ``LayerNorm(dtype=)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.layers import Conv, LayerNorm, Linear

MAX_CHARS = 16
PATCH = 8
# tokens per slot: a line of N slots is 32 x 32N, the backbone keeps the
# width and cuts the height to 8, so (8 / 8) x (32N / 8) = 4N patches
# (64 for the reference's 16 slots on a 32 x 512 line)
TOKENS_PER_SLOT = 4


def scaled_width(value: int, width: float, floor: int = 8,
                 multiple: int = 1) -> int:
    """Channel count scaled by a width multiplier (width=1.0 is exact);
    the same rule as ``marconet_tpu.models.encoder.scaled_width``."""
    v = int(round(value * width / multiple)) * multiple
    return max(floor, v)


# ---------------------------------------------------------------------------
# ResNet-45 backbone (height-only downsampling: 32 -> 8, width kept at 512)
# ---------------------------------------------------------------------------


class BasicBlock(nn.Module):
    """1x1 conv -> relu -> strided 3x3 conv, with 1x1 projection skip."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1), *,
                 device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        self.conv1 = Conv(in_ch, out_ch, 1, **kw)
        self.conv2 = Conv(out_ch, out_ch, 3, stride=stride, padding=1, **kw)
        self.downsample = None
        if tuple(stride) != (1, 1) or in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv(in_ch, out_ch, 1, stride=stride, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


class ResNet45(nn.Module):
    """Stages (blocks, stride): (3,(2,1)), (4,1), (6,(2,1)), (6,1), (3,1)."""

    STAGE_BLOCKS = (3, 4, 6, 6, 3)
    STAGE_STRIDES = ((2, 1), (1, 1), (2, 1), (1, 1), (1, 1))

    def __init__(self, stage_features=(32, 64, 128, 256, 512), *,
                 device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv(3, stage_features[0], 3, padding=1, bias=False,
                          **kw)
        cin = stage_features[0]
        for si, (blocks, feats, stride) in enumerate(zip(
                self.STAGE_BLOCKS, stage_features, self.STAGE_STRIDES)):
            layer = []
            for bi in range(blocks):
                layer.append(BasicBlock(cin, feats,
                                        stride if bi == 0 else (1, 1), **kw))
                cin = feats
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        for si in range(len(self.STAGE_BLOCKS)):
            x = getattr(self, f"layer{si + 1}")(x)
        return x                                    # (B, C, 8, 512)


# ---------------------------------------------------------------------------
# ViT head
# ---------------------------------------------------------------------------


def posemb_sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                     device=None) -> torch.Tensor:
    """2-D sin/cos positional embedding, (h*w, dim), f32.

    Layout: concat(sin(x*om), cos(x*om), sin(y*om), cos(y*om)).
    """
    if dim % 4:
        raise ValueError("posemb dim must be a multiple of 4")
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    omega = torch.arange(dim // 4, dtype=torch.float32, device=device) \
        / (dim // 4 - 1)
    omega = 1.0 / (temperature ** omega)
    xo = x.reshape(-1)[:, None] * omega[None, :]
    yo = y.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([xo.sin(), xo.cos(), yo.sin(), yo.cos()], dim=1)


class Patchify(nn.Module):
    """'b c (h p1) (w p2) -> b (h w) (p1 p2 c)' (the reference's einops
    rearrange)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        p = PATCH
        x = x.reshape(b, c, h // p, p, w // p, p)
        return x.permute(0, 2, 4, 3, 5, 1).reshape(
            b, (h // p) * (w // p), p * p * c)


class Attention(nn.Module):
    """Pre-norm multi-head self-attention (8 heads)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim, eps=1e-5, device=device)
        self.to_qkv = Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        # products of the compute-dtype values are exact in f32: JAX's
        # einsum(..., preferred_element_type=f32)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = torch.softmax(logits * self.dim_head ** -0.5, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    """LayerNorm -> Linear -> exact GELU -> Linear (keys ``net.0/1/3``)."""

    def __init__(self, dim: int, hidden: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.net = nn.Sequential(LayerNorm(dim, eps=1e-5, device=device),
                                 Linear(dim, hidden, **kw), nn.GELU(),
                                 Linear(hidden, dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class EncoderBlock(nn.ModuleList):
    """[Attention, FeedForward] with residuals (keys ``.0`` and ``.1``)."""

    def __init__(self, dim: int, mlp_dim: int, dim_head: int, *,
                 device=None, generator: torch.Generator):
        kw = dict(device=device, generator=generator)
        super().__init__([Attention(dim, dim_head=dim_head, **kw),
                          FeedForward(dim, mlp_dim, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x) + x
        return self[1](x) + x


class SeqProject(nn.Sequential):
    """LayerNorm over the sequence axis + Linear(sequence -> out_len).

    The reference's ``linear_seq_maxlen`` / ``linear_w_maxlen``: permute to
    (B, D, N), LayerNorm(N), Linear(N -> out), permute back.
    """

    def __init__(self, seq_len: int, out_len: int, *, device=None,
                 generator: torch.Generator):
        super().__init__(LayerNorm(seq_len, eps=1e-5, device=device),
                         Linear(seq_len, out_len, device=device,
                                generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, N, D)
        return self[1](self[0](x.transpose(1, 2))).transpose(1, 2)


class _Trunk(nn.Module):
    """Shared blocks, the three branches and the 64 -> 16 projection
    (the reference's ``transformer.transformer``)."""

    def __init__(self, dim, mlp_dim, dim_head, max_length, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.layers = nn.ModuleList(
            [EncoderBlock(dim, mlp_dim, dim_head, **kw) for _ in range(2)])
        self.layers_cls = nn.ModuleList(
            [EncoderBlock(dim, mlp_dim, dim_head, **kw)])
        self.layers_locs = nn.ModuleList(
            [EncoderBlock(dim, mlp_dim // 2, dim_head, **kw)])
        self.layers_w = nn.ModuleList(
            [EncoderBlock(dim, mlp_dim // 2, dim_head, **kw)])
        self.linear_seq_maxlen = SeqProject(TOKENS_PER_SLOT * max_length,
                                            max_length, **kw)


class TextViTHead(nn.Module):
    """Patch embedding, shared trunk and the cls / locs / w heads."""

    def __init__(self, in_ch: int, num_classes: int = 6736, dim: int = 512,
                 mlp_dim: int = 1024, dim_head: int = 64,
                 max_length: int = MAX_CHARS, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dim = dim
        self.to_patch_embedding = nn.Sequential(
            Patchify(), Linear(PATCH * PATCH * in_ch, dim, **kw))
        self.transformer = _Trunk(dim, mlp_dim, dim_head, max_length, **kw)

        def ln():
            return LayerNorm(dim, eps=1e-5, device=device)

        self.linear_cls = nn.Sequential(ln(), Linear(dim, num_classes, **kw))
        self.linear_locs = nn.Sequential(ln(), Linear(dim, dim // 2, **kw),
                                         nn.GELU(), Linear(dim // 2, 2, **kw))
        self.linear_w_maxlen = SeqProject(TOKENS_PER_SLOT * max_length, 1,
                                          **kw)
        self.linear_w = nn.Sequential(ln(), Linear(dim, dim, **kw))

    def forward(self, feat: torch.Tensor):
        b, _, h, w = feat.shape
        x = self.to_patch_embedding(feat)
        x = x + posemb_sincos_2d(h // PATCH, w // PATCH, self.dim,
                                 device=x.device).to(x.dtype)
        t = self.transformer
        for block in t.layers:
            x = block(x)
        x_cls = t.layers_cls[0](x)
        x_loc = t.layers_locs[0](t.linear_seq_maxlen(x))
        x_w = t.layers_w[0](x)

        logits = self.linear_cls(x_cls)
        locs = torch.sigmoid(self.linear_locs(x_loc)).reshape(b, -1)
        wvec = self.linear_w(self.linear_w_maxlen(x_w).reshape(b, self.dim))
        return logits, locs, wvec


class TextContextEncoder(nn.Module):
    """ResNet-45 + TextViT: the reference's ``TextContextEncoderV2``.

    ``width`` scales every channel dimension (1.0 = the exact reference
    architecture), with the JAX package's rounding rule.
    """

    def __init__(self, num_classes: int = 6736, width: float = 1.0,
                 max_length: int = MAX_CHARS, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        feats = tuple(scaled_width(f, width)
                      for f in (32, 64, 128, 256, 512))
        self.w_dim = scaled_width(512, width, floor=32, multiple=4)
        self.resnet = ResNet45(feats, **kw)
        self.transformer = TextViTHead(
            feats[-1], num_classes=num_classes, dim=self.w_dim,
            mlp_dim=2 * self.w_dim, dim_head=scaled_width(64, width),
            max_length=max_length, **kw)

    def forward(self, lq: torch.Tensor):
        """lq: (B, 3, 32, 512) NCHW in [-1, 1] -> (logits, locs, w)."""
        return self.transformer(self.resnet(lq))
