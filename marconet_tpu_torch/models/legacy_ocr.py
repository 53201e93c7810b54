"""Legacy transformer OCR (counterpart of ``marconet_tpu/models/
legacy_ocr.py``; the reference's ``models/ocr.py:310-370``,
``TransformerOCR``).

A BN ResNet-34-style conv encoder with maxpool downsampling
(``ocr.py:39-126``), a single-block autoregressive decoder at d = 1024
made of a 512-d character embedding beside a 512-d sinusoidal positional
encoding (``:281-308,325-343``), and a vocabulary head (6738 classes);
the ``net_new_bbox.pth`` variant adds a per-token box head. The reference
keeps it for the ``net_real_world_ocr.pth`` / ``net_new_bbox.pth``
checkpoints (disabled in ``checkpoints/download_github.py:6-7``), and so
does the port: it is on no path of the front-end.

Modules carry the reference's key names (``embedding_word.lut``,
``encoder.layer{i}.{j}``, ``decoder.mask_multihead.linears.{0-3}``,
``generator_word.proj``, ...), so such a checkpoint loads with
``convert.load_legacy_ocr``. Inputs are NHWC like the JAX module's; the
trunk runs NCHW. The greedy decode is a Python loop over a fixed number of
steps (the JAX module's ``fori_loop`` is its compiled form) that runs the
encoder once.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.layers import Conv, Linear, nchw

BN_EPS = 1e-5
NORM_EPS = 1e-6
D_EMBED = 512
D_MODEL = 1024
HEADS = 4


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (running statistics, eps 1e-5) with
    ``nn.BatchNorm2d``'s keys but no ``num_batches_tracked``."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


def _conv3(ci: int, co: int, kw) -> Conv:
    return Conv(ci, co, 3, padding=1, **kw)


class BNBlock(nn.Module):
    """conv-bn-relu-conv-bn residual block, projected by a conv and BN
    where the width changes (reference ``ocr.py:9-36``)."""

    def __init__(self, ci: int, co: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = _conv3(ci, co, kw)
        self.bn1 = BatchNorm(co, device=device)
        self.conv2 = _conv3(co, co, kw)
        self.bn2 = BatchNorm(co, device=device)
        self.downsample = nn.Sequential(
            _conv3(ci, co, kw), BatchNorm(co, device=device)) \
            if ci != co else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


# (channels, blocks) of the four stages
_PLAN = ((256, 3), (256, 4), (512, 6), (512, 3))


class OCREncoder(nn.Module):
    """Maxpool-downsampling BN ResNet, 3 -> 1024 channels."""

    def __init__(self, *, device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = _conv3(3, 64, kw)
        self.bn1 = BatchNorm(64, device=device)
        self.conv2 = _conv3(64, 128, kw)
        self.bn2 = BatchNorm(128, device=device)
        ci = 128
        for li, (ch, blocks) in enumerate(_PLAN, start=1):
            setattr(self, f"layer{li}", nn.Sequential(*[
                BNBlock(ci if bi == 0 else ch, ch, **kw)
                for bi in range(blocks)]))
            if li < 4:
                setattr(self, f"layer{li}_conv", _conv3(ch, ch, kw))
                setattr(self, f"layer{li}_bn", BatchNorm(ch, device=device))
            ci = ch
        self.layer4_conv2 = _conv3(512, D_MODEL, kw)
        self.layer4_conv2_bn = BatchNorm(D_MODEL, device=device)

    def forward(self, x):
        """x: (B, 3, H, W) -> (B, 1024, H / 16, W / 16)."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 2, 2)
        x = F.relu(self.bn2(self.conv2(x)))
        for li in range(1, 5):
            if li < 4:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"layer{li}")(x)
            if li < 4:
                x = F.relu(getattr(self, f"layer{li}_bn")(
                    getattr(self, f"layer{li}_conv")(x)))
        return F.relu(self.layer4_conv2_bn(self.layer4_conv2(x)))


def sinusoidal_pe(length: int, d_model: int) -> np.ndarray:
    pos = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * -(math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class MultiHeadAttention(nn.Module):
    """``linears.{0,1,2,3}``: the query, key, value and output
    projections."""

    def __init__(self, d: int, heads: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.linears = nn.ModuleList(
            [Linear(d, d, device=device, generator=generator)
             for _ in range(4)])

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        b, d = q.shape[0], q.shape[-1]
        dk = d // self.heads

        def proj(lin, t):
            return lin(t).reshape(b, t.shape[1], self.heads, dk) \
                .transpose(1, 2)

        qh, kh, vh = (proj(lin, t) for lin, t in
                      zip(self.linears[:3], (q, k, v)))
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(dk)
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        out = torch.softmax(scores, dim=-1) @ vh
        return self.linears[3](out.transpose(1, 2).reshape(b, -1, d))


class AddNorm(nn.Module):
    """The reference's hand-made LayerNorm: the unbiased std, eps added
    outside the square root (``ocr.py:211-222``)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(d, device=device))
        self.b_2 = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        std = ((x - mean).square().sum(-1, keepdim=True)
               / (x.shape[-1] - 1)).sqrt()
        return self.a_2 * (x - mean) / (std + NORM_EPS) + self.b_2


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.w_1 = Linear(d, hidden, device=device, generator=generator)
        self.w_2 = Linear(hidden, d, device=device, generator=generator)

    def forward(self, x):
        return self.w_2(F.relu(self.w_1(x)))


class Decoder(nn.Module):
    """Causal self-attention, cross-attention to the image features and a
    feed-forward layer, each with its residual and ``AddNorm``."""

    def __init__(self, *, device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.mask_multihead = MultiHeadAttention(D_MODEL, HEADS, **kw)
        self.mul_layernorm1 = AddNorm(D_MODEL, device=device)
        self.multihead = MultiHeadAttention(D_MODEL, HEADS, **kw)
        self.mul_layernorm2 = AddNorm(D_MODEL, device=device)
        self.pff = FeedForward(D_MODEL, 2 * D_MODEL, **kw)
        self.mul_layernorm3 = AddNorm(D_MODEL, device=device)

    def forward(self, text, memory):
        n = text.shape[1]
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=text.device).tril()
        x = self.mul_layernorm1(
            text + self.mask_multihead(text, text, text, mask=causal))
        x = self.mul_layernorm2(x + self.multihead(x, memory, memory))
        return self.mul_layernorm3(x + self.pff(x))


class _Embedding(nn.Module):
    """``lut``: the (vocab, 512) character table."""

    def __init__(self, vocab: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.lut = nn.Embedding(vocab, D_EMBED, device=device)
        with torch.no_grad():
            # flax Embed's default: normal with variance 1 / 512
            self.lut.weight.normal_(0.0, 1.0 / math.sqrt(D_EMBED),
                                    generator=generator)

    def forward(self, tokens):
        return self.lut(tokens)


class _Projection(nn.Module):
    def __init__(self, d: int, out: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.proj = Linear(d, out, device=device, generator=generator)

    def forward(self, x):
        return self.proj(x)


class LegacyTransformerOCR(nn.Module):
    """Autoregressive text recognizer (vocab 6738: the alphabet, blank and
    start / end tokens); ``use_loc_head`` adds ``generator_loc``, the
    per-token box head of ``net_new_bbox.pth`` (relu of a linear)."""

    def __init__(self, vocab: int = 6738, use_loc_head: bool = False, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embedding_word = _Embedding(vocab, **kw)
        self.encoder = OCREncoder(**kw)
        self.decoder = Decoder(**kw)
        self.generator_word = _Projection(D_MODEL, vocab, **kw)
        self.generator_loc = _Projection(D_MODEL, 1, **kw) \
            if use_loc_head else None

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> memory (B, H / 16 * W / 16, 1024)."""
        x = self.encoder(nchw(image).contiguous())
        return x.flatten(2).transpose(1, 2)

    def decode(self, memory: torch.Tensor, tokens: torch.Tensor):
        emb = self.embedding_word(tokens.long()) * math.sqrt(D_EMBED)
        pe = torch.as_tensor(sinusoidal_pe(tokens.shape[1], D_EMBED),
                             device=emb.device, dtype=emb.dtype)
        x = torch.cat([emb, pe.expand_as(emb)], dim=-1)
        x = self.decoder(x, memory)
        logits = self.generator_word(x)
        if self.generator_loc is not None:
            return logits, F.relu(self.generator_loc(x))
        return logits

    def forward(self, image: torch.Tensor, text_input: torch.Tensor):
        """image: (B, H, W, 3) NHWC; text_input: (B, T) tokens. Returns the
        vocabulary logits (B, T, vocab), and the locs (B, T, 1) with the
        box head."""
        return self.decode(self.encode(image), text_input)

    @torch.no_grad()
    def greedy_decode(self, image: torch.Tensor, max_len: int = 32,
                      start_token: int = 0) -> torch.Tensor:
        """Greedy decoding over ``max_len`` steps: token ``i + 1`` is the
        argmax of step ``i``'s logits over the tokens so far (the
        sequence is causal, so the later positions read no future). Returns
        (B, max_len) int64."""
        memory = self.encode(image)
        b = image.shape[0]
        tokens = torch.full((b, max_len + 1), start_token, dtype=torch.long,
                            device=image.device)
        for i in range(max_len):
            out = self.decode(memory, tokens[:, :-1])
            logits = out[0] if isinstance(out, tuple) else out
            tokens[:, i + 1] = logits[:, i].argmax(dim=-1)
        return tokens[:, 1:]
