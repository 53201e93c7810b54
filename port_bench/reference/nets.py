"""Plain PyTorch reference of MARCONet's networks, in float32.

Functional forwards over state dicts with the released checkpoints' key
names (``net_transformer_encoder.pth``, ``net_prior_generation.pth``,
``net_sr.pth``; basicsr's ``UNetDiscriminatorSN``; torchvision's VGG16
and lpips's linear heads), written from the reference's layer equations
(MARCONet, CVPR 2023, github.com/csxmli2016/MARCONet ``models/``). The
encoder, prior and SR forwards follow the functional oracle of the
repository's CPU suite, frozen here; the SR net runs its per-character
SFT loop over the valid characters of one line at a time, as the
reference's ``TSPSRNet`` does.

Nothing here imports the program. The ``*_spec`` functions list every
leaf (key, shape, initial distribution) at a channel ``width`` (1.0 = the
published networks), so the benchmark can make one set of weights and
hand it to both sides.

Every matrix product (conv, linear, attention) goes through ``ctx.q``, the
identity unless a control computes in a lower precision
(:mod:`port_bench.reference.quant`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
NUM_CLASSES = 6736
BLANK = 6735
MAX_CHARS = 16
_STAGES = ((3, 32), (4, 64), (6, 128), (6, 256), (3, 512))
_STRIDES = ((2, 1), (1, 1), (2, 1), (1, 1), (1, 1))
_GEN_CH = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128}
_PYRAMID = (8, 16, 32, 64, 128)
_VGG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def scaled(value: int, width: float, floor: int = 8,
           multiple: int = 1) -> int:
    """A channel count at ``width`` (1.0 is the published count)."""
    return max(floor, int(round(value * width / multiple)) * multiple)


class Ctx:
    """What a forward reads: the state dict, the spectral vectors it may
    advance (training mode), and the operand rounding ``q``."""

    def __init__(self, sd: Dict[str, torch.Tensor], q=None,
                 train: bool = False):
        self.sd = sd
        self.q = q or (lambda t: t)
        self.train = train

    def __getitem__(self, key):
        return self.sd[key]

    def __contains__(self, key):
        return key in self.sd


# ---------------------------------------------------------------------------
# leaves and their initial distributions
# ---------------------------------------------------------------------------
# An entry is (key, shape, kind, a, b): kind "normal" draws a + b * N(0, 1),
# "sn_u" / "sn_v" are the power-iteration vectors of the spectral weight
# named by the key's prefix (filled after the draw).


def _normal(out, key, shape, std, mean=0.0):
    out.append((key, tuple(shape), "normal", float(mean), float(std)))


def _sn(out, p, co, ci, k=3, bias=True):
    _normal(out, f"{p}.weight_orig", (co, ci, k, k),
            1.0 / math.sqrt(ci * k * k))
    out.append((f"{p}.weight_u", (co,), "sn_u", 0.0, 0.0))
    out.append((f"{p}.weight_v", (ci * k * k,), "sn_v", 0.0, 0.0))
    if bias:
        _normal(out, f"{p}.bias", (co,), 0.02)


def _norm(out, p, c):
    _normal(out, f"{p}.weight", (c,), 0.1, 1.0)
    _normal(out, f"{p}.bias", (c,), 0.02)


def _dense(out, p, o, i, bias=True):
    _normal(out, f"{p}.weight", (o, i), 1.0 / math.sqrt(i))
    if bias:
        _normal(out, f"{p}.bias", (o,), 0.02)


def encoder_spec(width: float = 1.0, num_classes: int = NUM_CLASSES,
                 max_chars: int = MAX_CHARS) -> List[tuple]:
    out: List[tuple] = []
    feats = [scaled(c, width) for _, c in _STAGES]
    dim = scaled(512, width, floor=32, multiple=4)
    head = scaled(64, width)
    inner = 8 * head
    _normal(out, "resnet.conv1.weight", (feats[0], 3, 3, 3), 1 / math.sqrt(27))
    cin = feats[0]
    for si, ((blocks, _), c, stride) in enumerate(zip(_STAGES, feats,
                                                       _STRIDES), start=1):
        for bi in range(blocks):
            p = f"resnet.layer{si}.{bi}"
            _normal(out, f"{p}.conv1.weight", (c, cin, 1, 1),
                    1 / math.sqrt(cin))
            _normal(out, f"{p}.conv2.weight", (c, c, 3, 3),
                    1 / math.sqrt(9 * c))
            if bi == 0 and (stride != (1, 1) or cin != c):
                _normal(out, f"{p}.downsample.0.weight", (c, cin, 1, 1),
                        1 / math.sqrt(cin))
            cin = c

    def block(p, hidden):
        _norm(out, f"{p}.0.norm", dim)
        _dense(out, f"{p}.0.to_qkv", 3 * inner, dim, bias=False)
        _dense(out, f"{p}.0.to_out", dim, inner, bias=False)
        _norm(out, f"{p}.1.net.0", dim)
        _dense(out, f"{p}.1.net.1", hidden, dim)
        _dense(out, f"{p}.1.net.3", dim, hidden)

    t = "transformer.transformer"
    _dense(out, "transformer.to_patch_embedding.1", dim, 64 * feats[-1])
    block(f"{t}.layers.0", 2 * dim)
    block(f"{t}.layers.1", 2 * dim)
    block(f"{t}.layers_cls.0", 2 * dim)
    block(f"{t}.layers_locs.0", dim)
    block(f"{t}.layers_w.0", dim)
    seq = 4 * max_chars
    _norm(out, f"{t}.linear_seq_maxlen.0", seq)
    _dense(out, f"{t}.linear_seq_maxlen.1", max_chars, seq)
    _norm(out, "transformer.linear_cls.0", dim)
    _dense(out, "transformer.linear_cls.1", num_classes, dim)
    _norm(out, "transformer.linear_locs.0", dim)
    _dense(out, "transformer.linear_locs.1", dim // 2, dim)
    _dense(out, "transformer.linear_locs.3", 2, dim // 2)
    _norm(out, "transformer.linear_w_maxlen.0", seq)
    _dense(out, "transformer.linear_w_maxlen.1", 1, seq)
    _norm(out, "transformer.linear_w.0", dim)
    _dense(out, "transformer.linear_w.1", dim, dim)
    return out


def prior_channels(width: float = 1.0) -> Dict[int, int]:
    return {r: scaled(c, width, floor=16) for r, c in _GEN_CH.items()}


def prior_spec(width: float = 1.0, num_classes: int = NUM_CLASSES
               ) -> List[tuple]:
    out: List[tuple] = []
    ch = prior_channels(width)
    sdim = scaled(512, width, floor=32, multiple=4)
    g = "TextGenerator"
    for i in range(1, 9):
        # EqualLinear(lr_mul=0.01) stores randn / lr_mul
        _normal(out, f"{g}.style_mlp.{i}.weight", (sdim, sdim), 100.0)
        _normal(out, f"{g}.style_mlp.{i}.bias", (sdim,), 0.02)
    _normal(out, f"{g}.input_text.TextEmbeddings", (num_classes, ch[4], 1, 1),
            1.0)

    def modconv(p, ci, co, k):
        _normal(out, f"{p}.conv.weight", (1, co, ci, k, k), 1.0)
        _normal(out, f"{p}.conv.modulation.weight", (ci, sdim), 1.0)
        _normal(out, f"{p}.conv.modulation.bias", (ci,), 0.02, 1.0)
        _normal(out, f"{p}.bias", (1, co, 1, 1), 0.02)

    def styled(p, ci, co):
        modconv(p, ci, co, 3)
        _normal(out, f"{p}.activate.bias", (co,), 0.02)

    styled(f"{g}.conv1", ch[4], ch[4])
    modconv(f"{g}.to_rgb1", ch[4], 3, 1)
    cin = ch[4]
    for i, res in enumerate(_PYRAMID):
        styled(f"{g}.convs.{2 * i}", cin, ch[res])
        styled(f"{g}.convs.{2 * i + 1}", ch[res], ch[res])
        modconv(f"{g}.to_rgbs.{i}", ch[res], 3, 1)
        cin = ch[res]
    return out


def srnet_spec(width: float = 1.0) -> List[tuple]:
    out: List[tuple] = []
    ch = prior_channels(width)
    d, pc = ch[64], ch[32]

    def res_block(p, ci, co):
        _norm(out, f"{p}.norm1", ci)
        _sn(out, f"{p}.conv1", co, ci)
        _norm(out, f"{p}.norm2", co)
        _sn(out, f"{p}.conv2", co, co)
        if ci != co:
            _normal(out, f"{p}.conv_out.weight", (co, ci, 1, 1),
                    1 / math.sqrt(ci))
            _normal(out, f"{p}.conv_out.bias", (co,), 0.02)

    _sn(out, "conv_first_32.0", d // 4, 3)
    _sn(out, "conv_first_16.0", d // 2, d // 4)
    _sn(out, "conv_first_8.0", d, d // 2)
    _sn(out, "conv_first_8.2", d, d)
    _sn(out, "conv_body_16.0", d, d + d // 2)
    _sn(out, "conv_body_16.2", d, d)
    _sn(out, "conv_body_32.0", d, d + d // 4)
    _sn(out, "conv_body_32.2", d, d)
    _sn(out, "conv_32_to256.0", d, pc)
    _sn(out, "conv_32_to256.2", d, d)
    for s in (32, 64):
        res_block(f"conv_{s}_fuse.0", 2 * d, d)
        for part in ("scale", "shift"):
            _sn(out, f"conv_{s}_{part}.0", d, d)
            _sn(out, f"conv_{s}_{part}.2", d, d)
    _sn(out, "conv_up.1", d, d)
    res_block("conv_up.3", d, d)
    _sn(out, "conv_up.4", d, d)
    _sn(out, "conv_final.0", d // 2, d)
    _sn(out, "conv_final.3", d // 4, d // 2)
    res_block("conv_final.5", d // 4, d // 4)
    _sn(out, "conv_final.6", 3, d // 4)
    return out


def disc_spec(in_ch: int, width: float = 1.0) -> List[tuple]:
    out: List[tuple] = []
    f = max(8, int(round(64 * width)))
    _normal(out, "conv0.weight", (f, in_ch, 3, 3), 1 / math.sqrt(9 * in_ch))
    _normal(out, "conv0.bias", (f,), 0.02)
    plan = ((f, 2 * f, 4), (2 * f, 4 * f, 4), (4 * f, 8 * f, 4),
            (8 * f, 4 * f, 3), (4 * f, 2 * f, 3), (2 * f, f, 3), (f, f, 3),
            (f, f, 3))
    for i, (ci, co, k) in enumerate(plan, start=1):
        _sn(out, f"conv{i}", co, ci, k, bias=False)
    _normal(out, "conv9.weight", (1, f, 3, 3), 1 / math.sqrt(9 * f))
    _normal(out, "conv9.bias", (1,), 0.02)
    return out


def lpips_plan(width: float = 1.0):
    """(feature index of each conv with its in / out channels, tap
    indices, tap channels) of the VGG16 trunk at ``width``."""
    convs, taps, idx, cin = [], [], 0, 3
    for bi, (c, n) in enumerate(_VGG):
        c = max(8, int(round(c * width)))
        for _ in range(n):
            convs.append((idx, cin, c))
            idx += 2
            cin = c
        taps.append(idx - 1)
        if bi < len(_VGG) - 1:
            idx += 1
    chans = [max(8, int(round(c * width))) for c, _ in _VGG]
    return convs, taps, chans


def lpips_spec(width: float = 1.0) -> List[tuple]:
    out: List[tuple] = []
    convs, _, chans = lpips_plan(width)
    for idx, ci, co in convs:
        _normal(out, f"features.{idx}.weight", (co, ci, 3, 3),
                math.sqrt(2.0 / (9 * ci)))
        _normal(out, f"features.{idx}.bias", (co,), 0.02)
    for i, c in enumerate(chans):
        _normal(out, f"lin{i}.model.1.weight", (1, c, 1, 1), 1.0 / c)
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def conv(ctx, x, w, b=None, stride=1, padding=0, groups=1):
    return F.conv2d(ctx.q(x), ctx.q(w), b, stride=stride, padding=padding,
                    groups=groups)


def linear(ctx, x, w, b=None):
    return F.linear(ctx.q(x), ctx.q(w), b)


def lin(ctx, p, x, bias=True):
    return linear(ctx, x, ctx[f"{p}.weight"],
                  ctx[f"{p}.bias"] if bias else None)


def flrelu(x, bias):
    return F.leaky_relu(x + bias, 0.2) * SQRT2


def up2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def sn_weight(ctx, p):
    """``weight_orig / sigma``; in training mode after one power
    iteration, whose vectors are stored back into ``ctx.sd``."""
    w = ctx[f"{p}.weight_orig"]
    wm = w.reshape(w.shape[0], -1)
    u, v = ctx[f"{p}.weight_u"], ctx[f"{p}.weight_v"]
    if ctx.train:
        with torch.no_grad():
            v = F.normalize(wm.T @ u, dim=0, eps=1e-12)
            u = F.normalize(wm @ v, dim=0, eps=1e-12)
        ctx.sd[f"{p}.weight_u"], ctx.sd[f"{p}.weight_v"] = u, v
    return w / torch.dot(u, wm @ v)


def sn_conv(ctx, p, x, stride=1, padding=1, w=None):
    w = sn_weight(ctx, p) if w is None else w
    b = ctx[f"{p}.bias"] if f"{p}.bias" in ctx else None
    return conv(ctx, x, w, b, stride=stride, padding=padding)


def group_norm(ctx, p, x):
    c = x.shape[1]
    return F.group_norm(x, c // min(32, c), ctx[f"{p}.weight"],
                        ctx[f"{p}.bias"], eps=1e-6)


def layer_norm(ctx, p, x):
    return F.layer_norm(x, (x.shape[-1],), ctx[f"{p}.weight"],
                        ctx[f"{p}.bias"], eps=1e-5)


def res_block(ctx, p, x_in, w):
    x = group_norm(ctx, f"{p}.norm1", x_in)
    x = sn_conv(ctx, f"{p}.conv1", x * torch.sigmoid(x), w=w[f"{p}.conv1"])
    x = group_norm(ctx, f"{p}.norm2", x)
    x = sn_conv(ctx, f"{p}.conv2", x * torch.sigmoid(x), w=w[f"{p}.conv2"])
    if f"{p}.conv_out.weight" in ctx:
        x_in = conv(ctx, x_in, ctx[f"{p}.conv_out.weight"],
                    ctx[f"{p}.conv_out.bias"])
    return x + x_in


def adain(prior, lq):
    def stats(f):
        b, c = f.shape[:2]
        flat = f.reshape(b, c, -1)
        return (flat.mean(2).view(b, c, 1, 1),
                (flat.var(dim=2) + 1e-5).sqrt().view(b, c, 1, 1))

    lm, ls = stats(lq)
    pm, ps = stats(prior)
    return (prior - pm) / ps * ls + lm


# ---------------------------------------------------------------------------
# encoder: ResNet-45 + ViT head
# ---------------------------------------------------------------------------


def _posemb(h, w, dim, device):
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing="ij")
    omega = torch.arange(dim // 4, device=device) / (dim // 4 - 1)
    omega = 1.0 / (10000 ** omega)
    y = y.flatten().float()[:, None] * omega[None, :]
    x = x.flatten().float()[:, None] * omega[None, :]
    return torch.cat((x.sin(), x.cos(), y.sin(), y.cos()), dim=1).float()


def _tblock(ctx, p, x):
    xn = layer_norm(ctx, f"{p}.0.norm", x)
    qkv = lin(ctx, f"{p}.0.to_qkv", xn, bias=False)
    b, n, _ = qkv.shape
    head = qkv.shape[-1] // 24
    q, k, v = (t.reshape(b, n, 8, head).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    a = torch.softmax(ctx.q(q) @ ctx.q(k).transpose(-1, -2) * head ** -0.5,
                      dim=-1)
    o = (ctx.q(a) @ ctx.q(v)).transpose(1, 2).reshape(b, n, 8 * head)
    x = lin(ctx, f"{p}.0.to_out", o, bias=False) + x
    y = F.gelu(lin(ctx, f"{p}.1.net.1", layer_norm(ctx, f"{p}.1.net.0", x)))
    return lin(ctx, f"{p}.1.net.3", y) + x


def _seq_project(ctx, p, x):
    x = layer_norm(ctx, f"{p}.0", x.transpose(1, 2))
    return lin(ctx, f"{p}.1", x).transpose(1, 2)


def encoder_forward(ctx: Ctx, lq):
    """lq (B, 3, 32, 512) in [-1, 1] -> (logits (B, 64, classes),
    locs (B, 2 * max_chars) as (left, right) pairs, w (B, dim))."""
    x = F.relu(conv(ctx, lq, ctx["resnet.conv1.weight"], padding=1))
    for si, ((blocks, _), stride) in enumerate(zip(_STAGES, _STRIDES),
                                               start=1):
        for bi in range(blocks):
            p = f"resnet.layer{si}.{bi}"
            st = stride if bi == 0 else (1, 1)
            y = F.relu(conv(ctx, x, ctx[f"{p}.conv1.weight"]))
            y = conv(ctx, y, ctx[f"{p}.conv2.weight"], stride=st, padding=1)
            if f"{p}.downsample.0.weight" in ctx:
                x = conv(ctx, x, ctx[f"{p}.downsample.0.weight"], stride=st)
            x = F.relu(y + x)
    b, c, hh, ww = x.shape
    x = x.reshape(b, c, hh // 8, 8, ww // 8, 8).permute(0, 2, 4, 3, 5, 1)
    x = x.reshape(b, (hh // 8) * (ww // 8), 64 * c)
    x = lin(ctx, "transformer.to_patch_embedding.1", x)
    dim = x.shape[-1]
    x = x + _posemb(hh // 8, ww // 8, dim, x.device)
    t = "transformer.transformer"
    x = _tblock(ctx, f"{t}.layers.0", x)
    x = _tblock(ctx, f"{t}.layers.1", x)
    x_cls = _tblock(ctx, f"{t}.layers_cls.0", x)
    x_loc = _tblock(ctx, f"{t}.layers_locs.0",
                    _seq_project(ctx, f"{t}.linear_seq_maxlen", x))
    x_w = _tblock(ctx, f"{t}.layers_w.0", x)
    logits = lin(ctx, "transformer.linear_cls.1",
                 layer_norm(ctx, "transformer.linear_cls.0", x_cls))
    lo = layer_norm(ctx, "transformer.linear_locs.0", x_loc)
    lo = F.gelu(lin(ctx, "transformer.linear_locs.1", lo))
    locs = torch.sigmoid(lin(ctx, "transformer.linear_locs.3", lo))
    xw = _seq_project(ctx, "transformer.linear_w_maxlen", x_w)
    w = lin(ctx, "transformer.linear_w.1",
            layer_norm(ctx, "transformer.linear_w.0", xw.reshape(b, dim)))
    return logits, locs.reshape(b, -1), w


# ---------------------------------------------------------------------------
# prior generator (StyleGAN over a character codebook)
# ---------------------------------------------------------------------------


def _mod_conv(ctx, p, x, style, demodulate=True, upsample=False):
    """StyleGAN2's modulated conv with the modulation and demodulation
    applied to the activations (its non-fused form, equal to the grouped
    conv over per-slot weights): ``conv(x * s, W / sqrt(fan_in)) * d``."""
    ci = x.shape[1]
    weight = ctx[f"{p}.weight"][0]                     # (O, I, k, k)
    k = weight.shape[-1]
    s = linear(ctx, style, ctx[f"{p}.modulation.weight"] / math.sqrt(
        style.shape[1]), ctx[f"{p}.modulation.bias"])  # (S, I)
    w = weight / math.sqrt(ci * k * k)
    x = x * s[:, :, None, None]
    if upsample:
        x = up2x(x)
    y = conv(ctx, x, w, padding=k // 2)
    if demodulate:
        d = torch.rsqrt((s[:, None, :].square()
                         * w.square().sum((2, 3))[None]).sum(-1) + 1e-8)
        y = y * d[:, :, None, None]
    return y


def _styled(ctx, p, x, style, upsample=False):
    y = _mod_conv(ctx, f"{p}.conv", x, style, upsample=upsample)
    bias = ctx[f"{p}.bias"].view(1, -1, 1, 1) + \
        ctx[f"{p}.activate.bias"].view(1, -1, 1, 1)
    return flrelu(y, bias)


def prior_forward(ctx: Ctx, styles, labels, block: int = 64):
    """styles (S, dim), labels (S,) -> (image (S, 3, 128, 128), feat64,
    feat32, rgb64, rgb32), in blocks of ``block`` slots."""
    outs = [_prior_block(ctx, styles[i:i + block], labels[i:i + block])
            for i in range(0, styles.shape[0], block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _prior_block(ctx, styles, labels):
    g = "TextGenerator"
    z = styles * torch.rsqrt(torch.mean(styles ** 2, dim=1, keepdim=True)
                             + 1e-8)
    for i in range(1, 9):
        wgt = ctx[f"{g}.style_mlp.{i}.weight"]
        z = linear(ctx, z, wgt * (0.01 / math.sqrt(wgt.shape[1])))
        z = flrelu(z, ctx[f"{g}.style_mlp.{i}.bias"] * 0.01)
    x = ctx[f"{g}.input_text.TextEmbeddings"][labels].repeat(1, 1, 4, 4)
    x = _styled(ctx, f"{g}.conv1", x, z)
    y = _mod_conv(ctx, f"{g}.to_rgb1.conv", x, z, demodulate=False)
    skip = torch.tanh(y + ctx[f"{g}.to_rgb1.bias"])
    feats = {}
    for i, res in enumerate(_PYRAMID):
        x = _styled(ctx, f"{g}.convs.{2 * i}", x, z, upsample=True)
        x = _styled(ctx, f"{g}.convs.{2 * i + 1}", x, z)
        y = _mod_conv(ctx, f"{g}.to_rgbs.{i}.conv", x, z, demodulate=False)
        skip = torch.tanh(y + ctx[f"{g}.to_rgbs.{i}.bias"] + up2x(skip))
        feats[res] = (x, skip)
    return skip, feats[64][0], feats[32][0], feats[64][1], feats[32][1]


# ---------------------------------------------------------------------------
# SR net with per-character SFT
# ---------------------------------------------------------------------------

def _sn_keys(ctx):
    return [k[:-len(".weight_orig")] for k in ctx.sd
            if k.endswith(".weight_orig")]


def _stack(ctx, p, x, w):
    x = F.leaky_relu(sn_conv(ctx, f"{p}.0", x, w=w[f"{p}.0"]), 0.2)
    return sn_conv(ctx, f"{p}.2", x, w=w[f"{p}.2"])


def window_start(center_loc: float, half: int, width: int) -> Tuple[int, int]:
    """(x1, x2) of a character's window: ``floor(loc * W)`` in float32,
    clamped to the canvas (the reference's ``int(loc * W)`` of a float32
    loc, half-width ignored)."""
    c = int(np.floor(np.float32(center_loc) * np.float32(width)))
    x1 = 0 if c < half else c - half
    x2 = width if c + half > width else c + half
    return x1, max(x2, x1)


def _sft(ctx, s, canvas, priors, centers, w):
    """One line: canvas (1, C, H, W); priors (n, C, H, 2h); centers: n
    float32 locs."""
    half = priors.shape[-1] // 2
    width = canvas.shape[-1]
    res = torch.zeros_like(canvas)
    for c, loc in enumerate(centers):
        x1, x2 = window_start(loc, half, width)
        length = x2 - x1
        if length <= 0:
            continue
        y1 = half - length // 2
        pf = priors[c:c + 1, :, :, y1:y1 + length]
        lf = canvas[:, :, :, x1:x2]
        fuse = res_block(ctx, f"conv_{s}_fuse.0",
                         torch.cat((adain(pf, lf), lf), dim=1), w)
        out = lf * _stack(ctx, f"conv_{s}_scale", fuse, w) + \
            _stack(ctx, f"conv_{s}_shift", fuse, w)
        res = torch.cat([res[..., :x1], out, res[..., x2:]], dim=-1)
    return canvas + res


def srnet_forward(ctx: Ctx, lq, feat64: List, feat32: List, centers: List):
    """lq (B, 3, 32, 512); per line b the valid characters' features
    feat64[b] (n_b, d, 64, 64) and feat32[b] (n_b, pc, 32, 32) and their
    float32 center locs -> (B, 3, 128, 2048). Each spectral weight is
    normalized once per forward (one power iteration in training mode)."""
    w = {p: sn_weight(ctx, p) for p in _sn_keys(ctx)}
    lrelu = lambda t: F.leaky_relu(t, 0.2)      # noqa: E731
    f32 = lrelu(sn_conv(ctx, "conv_first_32.0", lq, w=w["conv_first_32.0"]))
    f16 = lrelu(sn_conv(ctx, "conv_first_16.0", f32, stride=2,
                        w=w["conv_first_16.0"]))
    f8 = sn_conv(ctx, "conv_first_8.2", lrelu(sn_conv(
        ctx, "conv_first_8.0", f16, stride=2, w=w["conv_first_8.0"])),
        w=w["conv_first_8.2"])
    s16 = _stack(ctx, "conv_body_16", torch.cat((up2x(f8), f16), 1), w)
    s32 = _stack(ctx, "conv_body_32", torch.cat((up2x(s16), f32), 1), w)
    rows = []
    for b in range(lq.shape[0]):
        canvas = s32[b:b + 1]
        if len(centers[b]):
            p32 = _stack(ctx, "conv_32_to256", feat32[b], w)
            canvas = _sft(ctx, 32, canvas, p32, centers[b], w)
        u = lrelu(sn_conv(ctx, "conv_up.1", up2x(canvas), w=w["conv_up.1"]))
        u = res_block(ctx, "conv_up.3", u, w)
        s64 = sn_conv(ctx, "conv_up.4", u, w=w["conv_up.4"])
        if len(centers[b]):
            s64 = _sft(ctx, 64, s64, feat64[b], centers[b], w)
        y = lrelu(sn_conv(ctx, "conv_final.0", s64, w=w["conv_final.0"]))
        y = lrelu(sn_conv(ctx, "conv_final.3", up2x(y), w=w["conv_final.3"]))
        y = res_block(ctx, "conv_final.5", y, w)
        rows.append(torch.tanh(sn_conv(ctx, "conv_final.6", y,
                                       w=w["conv_final.6"])))
    return torch.cat(rows)


# ---------------------------------------------------------------------------
# training-only networks
# ---------------------------------------------------------------------------


def disc_forward(ctx: Ctx, x):
    """basicsr UNetDiscriminatorSN: x (B, C, H, W) -> (B, 1, H, W)."""
    lrelu = lambda t: F.leaky_relu(t, 0.2)      # noqa: E731
    x0 = lrelu(conv(ctx, x, ctx["conv0.weight"], ctx["conv0.bias"],
                    padding=1))
    x1 = lrelu(sn_conv(ctx, "conv1", x0, stride=2))
    x2 = lrelu(sn_conv(ctx, "conv2", x1, stride=2))
    x3 = lrelu(sn_conv(ctx, "conv3", x2, stride=2))
    x4 = lrelu(sn_conv(ctx, "conv4", up2x(x3))) + x2
    x5 = lrelu(sn_conv(ctx, "conv5", up2x(x4))) + x1
    x6 = lrelu(sn_conv(ctx, "conv6", up2x(x5))) + x0
    out = lrelu(sn_conv(ctx, "conv7", x6))
    out = lrelu(sn_conv(ctx, "conv8", out))
    return conv(ctx, out, ctx["conv9.weight"], ctx["conv9.bias"], padding=1)


def lpips_forward(ctx: Ctx, pred, target, width: float = 1.0):
    """lpips.LPIPS(net='vgg') distance of two (B, 3, H, W) batches in
    [-1, 1] -> (B,)."""
    convs, taps, _ = lpips_plan(width)
    conv_at = {idx: idx for idx, _, _ in convs}
    shift = torch.tensor(_LPIPS_SHIFT, device=pred.device).view(1, 3, 1, 1)
    scale = torch.tensor(_LPIPS_SCALE, device=pred.device).view(1, 3, 1, 1)

    def feats(x):
        x = (x - shift) / scale
        out, idx = [], 0
        last = max(taps)
        while idx <= last:
            if idx in conv_at:
                x = F.relu(conv(ctx, x, ctx[f"features.{idx}.weight"],
                                ctx[f"features.{idx}.bias"], padding=1))
                idx += 2
                if idx - 1 in taps:
                    out.append(x)
            else:
                x = F.max_pool2d(x, 2, 2)
                idx += 1
        return out

    total = 0.0
    for i, (a, b) in enumerate(zip(feats(pred), feats(target))):
        a = a * torch.rsqrt(a.square().sum(1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt(b.square().sum(1, keepdim=True) + 1e-10)
        r = conv(ctx, (a - b).square(), ctx[f"lin{i}.model.1.weight"])
        total = total + r.mean(dim=(1, 2, 3))
    return total


def restore_lines(ctxs: Dict[str, Ctx], lq, labels: List[List[int]],
                  centers: List[List[float]], block: int = 8):
    """The restore of a list of lines, f32: the ``encoder``, ``prior`` and
    ``srnet`` contexts; lq (B, 32, 512, 3) NHWC in [-1, 1], each line's
    valid labels and float32 center locs -> (sr (B, 128, 2048, 3),
    priors: per line (n, 128, 128, 3)), in blocks of ``block`` lines."""
    srs, priors = [], []
    for i in range(0, lq.shape[0], block):
        x = lq[i:i + block].permute(0, 3, 1, 2).contiguous()
        _, _, w = encoder_forward(ctxs["encoder"], x)
        labs = labels[i:i + block]
        n = [len(l) for l in labs]
        flat = [l for line in labs for l in line]
        f64s, f32s = [None] * len(labs), [None] * len(labs)
        if flat:
            styles = torch.repeat_interleave(
                w, torch.tensor(n, device=w.device), dim=0)
            img, f64, f32, _, _ = prior_forward(
                ctxs["prior"], styles, torch.tensor(flat, device=w.device))
            f64s = list(torch.split(f64, n))
            f32s = list(torch.split(f32, n))
            imgs = torch.split(img, n)
        else:
            imgs = [img_empty(w.device)] * len(labs)
        sr = srnet_forward(ctxs["srnet"], x, f64s, f32s, centers[i:i + block])
        srs.append(sr.permute(0, 2, 3, 1))
        priors += [t.permute(0, 2, 3, 1) for t in imgs]
    return torch.cat(srs), priors


def img_empty(device):
    return torch.zeros(0, 3, 128, 128, device=device)
