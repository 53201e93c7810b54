"""Plain reference of MARCONet's default front end, in float32.

``test_sr.py`` without ``-m`` (``test_sr.py:55-56,85-94``) reads each line
through ``utils/yolo_ocr_xloc.py:7-103``: Ultralytics YOLO11-m finds the
character boxes (letterbox to 640, conf 0.07, IoU 0.1), the boxes are
sorted left to right, and for each box a window of 5 boxes is cropped,
soft-masked outside its boxes to the mean background colour through a
15 x 15 Gaussian of the box mask, and read by ModelScope's ConvNeXt-ViT
CTC recognizer (``damo/cv_convnextTiny_ocr-recognition-general_damo``);
the box takes the character at its place in the window's text.

Written here from those sources with plain PyTorch and numpy:

* YOLO11 at scale m (``yolo11.yaml``: depth 0.5, width 1.0, max channels
  512, one class) over an Ultralytics-keyed state dict (``model.{i}.*``):
  Conv-BN-SiLU, C3k2, SPPF, C2PSA, the FPN / PAN neck, the Detect head and
  its DFL decode;
* Ultralytics' ``LetterBox`` (``auto``: pad to the next multiple of 32,
  split by ``round(d -/+ 0.1)``, gray 114) over OpenCV's uint8
  ``INTER_LINEAR`` (11-bit weights, exact horizontal sums, the vertical
  rounding of ``cv::resize``'s SIMD path);
* a greedy NMS and the boxes mapped back to the line;
* the 5-box masking with OpenCV's ``GaussianBlur(mask, (15, 15), 0)`` on
  uint8 (8-bit kernel with error diffusion, ``BORDER_REFLECT_101``) and the
  recognizer's input resize, restated without cv2;
* the ConvNeXt trunk (stem stride 4, height-only (2, 1) downsampling), the
  ViT blocks (timm keys), the CTC head and the greedy CTC decode.

Nothing here imports the program. Every matrix product (conv, linear,
attention) goes through ``ctx.q``, the identity unless a control computes
in a lower precision (:mod:`port_bench.reference.quant`).

Departures from Ultralytics and ModelScope:

* NMS takes the ``max_det`` best candidates at or above conf and then
  suppresses greedily, as the port and the JAX package do; Ultralytics
  suppresses among every candidate above conf and keeps the first
  ``max_det``. The two agree whenever at most ``max_det`` candidates pass
  conf.
* The recognizer reads the masked window in colour, resized to height 32
  and to the positional embedding's width (``4 * seq_len``), edge-padded
  when narrower, normalized ``(x / 255 - 0.5) / 0.5``; ModelScope's own
  pipeline (its crop width and chunking) is not in the repository.
* The state dicts are the modules' own: Ultralytics' keys as they are,
  ModelScope's without their ``recognizer.`` prefix.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import nets

REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
LN_EPS = 1e-6
CONF, IOU, IMGSZ, MAX_DET = 0.07, 0.1, 640, 100
WINDOW, EXPAND_PX, EXPAND_EDGE, BLUR = 5, 1, 12, 15
OCR_HEIGHT = 32

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


# ---------------------------------------------------------------------------
# leaves and their initial distributions (see nets: (key, shape, "normal",
# mean, std))
# ---------------------------------------------------------------------------


def _conv_bn(out, p, ci, co, k, groups=1):
    nets._normal(out, f"{p}.conv.weight", (co, ci // groups, k, k),
                 1.0 / math.sqrt(ci // groups * k * k))
    nets._normal(out, f"{p}.bn.weight", (co,), 0.1, 1.0)
    nets._normal(out, f"{p}.bn.bias", (co,), 0.1)
    nets._normal(out, f"{p}.bn.running_mean", (co,), 0.1)
    nets._normal(out, f"{p}.bn.running_var", (co,), 0.1, 1.0)


def _bottleneck_spec(out, p, c, e):
    h = int(c * e)
    _conv_bn(out, f"{p}.cv1", c, h, 3)
    _conv_bn(out, f"{p}.cv2", h, c, 3)


def _c3k2_spec(out, p, ci, co, e, c3k):
    c = int(co * e)
    _conv_bn(out, f"{p}.cv1", ci, 2 * c, 1)
    if c3k:
        h = c // 2
        _conv_bn(out, f"{p}.m.0.cv1", c, h, 1)
        _conv_bn(out, f"{p}.m.0.cv2", c, h, 1)
        _conv_bn(out, f"{p}.m.0.cv3", 2 * h, c, 1)
        for i in range(2):
            _bottleneck_spec(out, f"{p}.m.0.m.{i}", h, 1.0)
    else:
        _bottleneck_spec(out, f"{p}.m.0", c, 0.5)
    _conv_bn(out, f"{p}.cv2", 3 * c, co, 1)


# (index, in, out, e, c3k) of the C3k2 stages of yolo11.yaml at scale m
_C3K2 = ((2, 128, 256, 0.25, False), (4, 256, 512, 0.25, False),
         (6, 512, 512, 0.5, True), (8, 512, 512, 0.5, True),
         (13, 1024, 512, 0.5, False), (16, 1024, 256, 0.5, False),
         (19, 768, 512, 0.5, False), (22, 1024, 512, 0.5, True))
# (index, in, out) of the stride-2 3x3 convs
_DOWN = ((0, 3, 64), (1, 64, 128), (3, 256, 256), (5, 512, 512),
         (7, 512, 512), (17, 256, 256), (20, 512, 512))
_LEVELS = (256, 512, 512)
CLS_BIAS = -2.0


def yolo_spec(nc: int = 1) -> List[tuple]:
    """Every leaf of YOLO11-m (``nc`` classes) under Ultralytics' keys. BN
    statistics near identity with a spread, so activations keep their
    scale through the 23 layers; the class logits' bias at ``CLS_BIAS``."""
    out: List[tuple] = []
    down = {i: (ci, co) for i, ci, co in _DOWN}
    stages = {i: rest for i, *rest in _C3K2}
    for i in range(23):
        if i in down:
            _conv_bn(out, f"model.{i}", *down[i], 3)
        elif i in stages:
            _c3k2_spec(out, f"model.{i}", *stages[i])
        elif i == 9:
            _conv_bn(out, "model.9.cv1", 512, 256, 1)
            _conv_bn(out, "model.9.cv2", 1024, 512, 1)
        elif i == 10:
            _conv_bn(out, "model.10.cv1", 512, 512, 1)
            _conv_bn(out, "model.10.cv2", 512, 512, 1)
            p, c = "model.10.m.0", 256
            _conv_bn(out, f"{p}.attn.qkv", c, 2 * c, 1)
            _conv_bn(out, f"{p}.attn.proj", c, c, 1)
            _conv_bn(out, f"{p}.attn.pe", c, c, 3, groups=c)
            _conv_bn(out, f"{p}.ffn.0", c, 2 * c, 1)
            _conv_bn(out, f"{p}.ffn.1", 2 * c, c, 1)
    c2, c3 = max(16, _LEVELS[0] // 4, REG_MAX * 4), max(_LEVELS[0], nc)
    for i, c in enumerate(_LEVELS):
        p = f"model.23.cv2.{i}"
        _conv_bn(out, f"{p}.0", c, c2, 3)
        _conv_bn(out, f"{p}.1", c2, c2, 3)
        nets._normal(out, f"{p}.2.weight", (4 * REG_MAX, c2, 1, 1),
                     1.0 / math.sqrt(c2))
        nets._normal(out, f"{p}.2.bias", (4 * REG_MAX,), 0.1)
        p = f"model.23.cv3.{i}"
        _conv_bn(out, f"{p}.0.0", c, c, 3, groups=c)
        _conv_bn(out, f"{p}.0.1", c, c3, 1)
        _conv_bn(out, f"{p}.1.0", c3, c3, 3, groups=c3)
        _conv_bn(out, f"{p}.1.1", c3, c3, 1)
        nets._normal(out, f"{p}.2.weight", (nc, c3, 1, 1),
                     1.0 / math.sqrt(c3))
        nets._normal(out, f"{p}.2.bias", (nc,), 0.1, CLS_BIAS)
    return out


def ocr_spec(ocr: Dict) -> List[tuple]:
    """Every leaf of the ConvNeXt-ViT recognizer of configuration ``ocr``
    (``depths``, ``dims``, ``vit_depth``, ``vit_dim``, ``vit_mlp_ratio``,
    ``num_classes``, ``seq_len``; no cls token, no projection, layer
    scale) under ModelScope's keys without their prefix."""
    out: List[tuple] = []
    dims, vd = ocr["dims"], ocr["vit_dim"]
    if vd != dims[-1]:
        raise ValueError("the reference's recognizer has no projection: "
                         "vit_dim must equal the last ConvNeXt width")

    def ln(p, c):
        nets._normal(out, f"{p}.weight", (c,), 0.1, 1.0)
        nets._normal(out, f"{p}.bias", (c,), 0.02)

    def dense(p, o, i):
        nets._dense(out, p, o, i)

    nets._normal(out, "downsample_layers.0.0.weight", (dims[0], 3, 4, 4),
                 1.0 / math.sqrt(48))
    nets._normal(out, "downsample_layers.0.0.bias", (dims[0],), 0.02)
    ln("downsample_layers.0.1", dims[0])
    for i in range(1, len(dims)):
        ln(f"downsample_layers.{i}.0", dims[i - 1])
        nets._normal(out, f"downsample_layers.{i}.1.weight",
                     (dims[i], dims[i - 1], 2, 1),
                     1.0 / math.sqrt(2 * dims[i - 1]))
        nets._normal(out, f"downsample_layers.{i}.1.bias", (dims[i],), 0.02)
    for s, (depth, c) in enumerate(zip(ocr["depths"], dims)):
        for b in range(depth):
            p = f"stages.{s}.{b}"
            nets._normal(out, f"{p}.dwconv.weight", (c, 1, 7, 7), 1.0 / 7)
            nets._normal(out, f"{p}.dwconv.bias", (c,), 0.02)
            ln(f"{p}.norm", c)
            dense(f"{p}.pwconv1", 4 * c, c)
            dense(f"{p}.pwconv2", c, 4 * c)
            nets._normal(out, f"{p}.gamma", (c,), 0.02, 0.1)
    nets._normal(out, "pos_embed", (1, ocr["seq_len"], vd), 0.02)
    hidden = int(vd * ocr["vit_mlp_ratio"])
    for i in range(ocr["vit_depth"]):
        p = f"blocks.{i}"
        ln(f"{p}.norm1", vd)
        dense(f"{p}.attn.qkv", 3 * vd, vd)
        dense(f"{p}.attn.proj", vd, vd)
        ln(f"{p}.norm2", vd)
        dense(f"{p}.mlp.fc1", hidden, vd)
        dense(f"{p}.mlp.fc2", vd, hidden)
    ln("norm", vd)
    dense("head", ocr["num_classes"], vd)
    return out


# ---------------------------------------------------------------------------
# YOLO11-m
# ---------------------------------------------------------------------------


def conv_bn(ctx, p, x, stride=1, groups=1, act=True):
    w = ctx[f"{p}.conv.weight"]
    y = nets.conv(ctx, x, w, stride=stride, padding=w.shape[-1] // 2,
                  groups=groups)
    y = F.batch_norm(y, ctx[f"{p}.bn.running_mean"],
                     ctx[f"{p}.bn.running_var"], ctx[f"{p}.bn.weight"],
                     ctx[f"{p}.bn.bias"], training=False, eps=BN_EPS)
    return F.silu(y) if act else y


def _bottleneck(ctx, p, x):
    return x + conv_bn(ctx, f"{p}.cv2", conv_bn(ctx, f"{p}.cv1", x))


def _c3k2(ctx, p, x, c3k):
    parts = list(conv_bn(ctx, f"{p}.cv1", x).chunk(2, 1))
    y = parts[-1]
    if c3k:
        a = conv_bn(ctx, f"{p}.m.0.cv1", y)
        for i in range(2):
            a = _bottleneck(ctx, f"{p}.m.0.m.{i}", a)
        y = conv_bn(ctx, f"{p}.m.0.cv3",
                    torch.cat([a, conv_bn(ctx, f"{p}.m.0.cv2", y)], 1))
    else:
        y = _bottleneck(ctx, f"{p}.m.0", y)
    return conv_bn(ctx, f"{p}.cv2", torch.cat(parts + [y], 1))


def _sppf(ctx, x):
    outs = [conv_bn(ctx, "model.9.cv1", x)]
    for _ in range(3):
        outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
    return conv_bn(ctx, "model.9.cv2", torch.cat(outs, 1))


def _c2psa(ctx, x):
    a, b = conv_bn(ctx, "model.10.cv1", x).chunk(2, 1)
    p = "model.10.m.0"
    n, c, h, w = b.shape
    heads, kd, hd = c // 64, 32, 64
    q, k, v = conv_bn(ctx, f"{p}.attn.qkv", b, act=False).reshape(
        n, heads, 2 * kd + hd, h * w).split([kd, kd, hd], dim=2)
    attn = torch.softmax(ctx.q(q).transpose(-2, -1) @ ctx.q(k)
                         * kd ** -0.5, dim=-1)
    y = (ctx.q(v) @ ctx.q(attn).transpose(-2, -1)).reshape(n, c, h, w)
    y = y + conv_bn(ctx, f"{p}.attn.pe", v.reshape(n, c, h, w), groups=c,
                    act=False)
    b = b + conv_bn(ctx, f"{p}.attn.proj", y, act=False)
    b = b + conv_bn(ctx, f"{p}.ffn.1", conv_bn(ctx, f"{p}.ffn.0", b),
                    act=False)
    return conv_bn(ctx, "model.10.cv2", torch.cat([a, b], 1))


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def yolo_forward(ctx, x_nhwc: torch.Tensor):
    """x (B, H, W, 3) in [0, 1], H and W multiples of 32 -> (boxes (B, A,
    4) xyxy px, scores (B, A, nc)) over the anchors of the three levels,
    row-major within a level."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    for i in (0, 1):
        x = conv_bn(ctx, f"model.{i}", x, stride=2)
    x4 = _c3k2(ctx, "model.4", conv_bn(ctx, "model.3", _c3k2(
        ctx, "model.2", x, False), stride=2), False)
    x6 = _c3k2(ctx, "model.6", conv_bn(ctx, "model.5", x4, stride=2), True)
    x8 = _c3k2(ctx, "model.8", conv_bn(ctx, "model.7", x6, stride=2), True)
    x10 = _c2psa(ctx, _sppf(ctx, x8))
    x13 = _c3k2(ctx, "model.13", torch.cat([_up(x10), x6], 1), False)
    x16 = _c3k2(ctx, "model.16", torch.cat([_up(x13), x4], 1), False)
    x19 = _c3k2(ctx, "model.19", torch.cat(
        [conv_bn(ctx, "model.17", x16, stride=2), x13], 1), False)
    x22 = _c3k2(ctx, "model.22", torch.cat(
        [conv_bn(ctx, "model.20", x19, stride=2), x10], 1), True)
    boxes, scores = [], []
    for i, (f, stride) in enumerate(zip((x16, x19, x22), STRIDES)):
        p = f"model.23.cv2.{i}"
        br = conv_bn(ctx, f"{p}.1", conv_bn(ctx, f"{p}.0", f))
        br = nets.conv(ctx, br, ctx[f"{p}.2.weight"], ctx[f"{p}.2.bias"])
        p = f"model.23.cv3.{i}"
        cr = conv_bn(ctx, f"{p}.0.0", f, groups=f.shape[1])
        cr = conv_bn(ctx, f"{p}.0.1", cr)
        cr = conv_bn(ctx, f"{p}.1.0", cr, groups=cr.shape[1])
        cr = conv_bn(ctx, f"{p}.1.1", cr)
        cr = nets.conv(ctx, cr, ctx[f"{p}.2.weight"], ctx[f"{p}.2.bias"])
        b, _, h, w = br.shape
        dist = torch.softmax(br.permute(0, 2, 3, 1).reshape(
            b, h * w, 4, REG_MAX), dim=-1)
        dist = (dist * torch.arange(REG_MAX, dtype=dist.dtype,
                                    device=dist.device)).sum(-1)
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=dist.dtype, device=dist.device) + 0.5,
            torch.arange(w, dtype=dist.dtype, device=dist.device) + 0.5,
            indexing="ij")
        anchor = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
        boxes.append(torch.cat([anchor - dist[..., :2],
                                anchor + dist[..., 2:]], -1) * stride)
        scores.append(torch.sigmoid(cr.permute(0, 2, 3, 1).reshape(
            b, h * w, -1)))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


# ---------------------------------------------------------------------------
# OpenCV's uint8 resize and blur, Ultralytics' letterbox
# ---------------------------------------------------------------------------


def _linear_axis(n_out: int, n_in: int, edge_weight_one: bool):
    """(left index, right index, left weight, right weight) of one axis of
    ``cv::resize``'s uint8 INTER_LINEAR: the source coordinate
    ``(d + 0.5) * n_in / n_out - 0.5`` in float32, weights in 11 bits.
    Horizontally a coordinate outside the source takes the edge pixel at
    full weight; vertically the edge row is taken twice with the
    fractional weights."""
    src = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(
        np.float32)
    left = np.floor(src).astype(np.int64)
    frac = src - left.astype(np.float32)
    if edge_weight_one:
        low, high = left < 0, left >= n_in - 1
        frac[low | high] = 0.0
        left[low] = 0
        left[high] = n_in - 1
    w_left = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE))
    w_right = np.rint(frac * np.float32(_COEF_SCALE))
    return (np.clip(left, 0, n_in - 1), np.clip(left + 1, 0, n_in - 1),
            w_left.astype(np.int64), w_right.astype(np.int64))


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    of an (H, W, C) uint8 image: horizontal sums exact in integers, then
    each vertical pair ``((b * (row >> 4)) >> 16)`` summed and rounded
    ``(s + 2) >> 2``."""
    h, w, c = img.shape
    x0, x1, a0, a1 = _linear_axis(out_w, w, True)
    y0, y1, b0, b1 = _linear_axis(out_h, h, False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    top = (b0[:, None, None] * (rows[y0] >> 4)) >> 16
    bottom = (b1[:, None, None] * (rows[y1] >> 4)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


def letterbox(img: np.ndarray, size: int = IMGSZ, stride: int = 32):
    """Ultralytics ``LetterBox(auto=True)``: (padded uint8 image, gain,
    (top, left))."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = ((size - nw) % stride) / 2, ((size - nh) % stride) / 2
    if (nw, nh) != (w, h):
        img = resize_linear(img, nw, nh)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((nh + top + bottom, nw + left + right, 3), 114, np.uint8)
    out[top:top + nh, left:left + nw] = img
    return out, r, (top, left)


def letterbox_shape(h: int, w: int, size: int = IMGSZ,
                    stride: int = 32) -> Tuple[int, int]:
    """The (height, width) :func:`letterbox` gives an ``h`` x ``w``
    image."""
    r = min(size / h, size / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    return (nh + (size - nh) % stride, nw + (size - nw) % stride)


def _gauss_taps(ksize: int) -> np.ndarray:
    """OpenCV's 8-bit Gaussian for ``sigma = 0`` on uint8: the float
    kernel (``sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8``) scaled by 256
    and rounded from the tails inward, each rounding's error carried to
    the next tap, the centre taking the rest of 256."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = ksize // 2
    vals = np.exp(-((np.arange(ksize) - half) ** 2)
                  / (2.0 * sigma * sigma))
    vals = vals / vals.sum()
    taps = np.zeros(ksize, np.int64)
    carry = 0.0
    for i in range(half):
        v = vals[i] * 256.0 + carry
        taps[i] = taps[ksize - 1 - i] = int(np.rint(v))
        carry = v - taps[i]
    taps[half] = 256 - 2 * int(taps[:half].sum())
    return taps


def _reflect101(n: int, pad: int) -> np.ndarray:
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def gaussian_blur(img: np.ndarray, ksize: int = BLUR) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` of a 2-D uint8 image:
    integer row and column sums of the 8-bit taps, rounded once
    (``(s + 2**15) >> 16``), borders reflected without the edge."""
    taps = _gauss_taps(ksize)
    r = ksize // 2
    h, w = img.shape
    src = img.astype(np.int64)
    xs, ys = _reflect101(w, r), _reflect101(h, r)
    rows = sum(t * src[:, xs[i:i + w]] for i, t in enumerate(taps))
    cols = sum(t * rows[ys[i:i + h]] for i, t in enumerate(taps))
    return np.clip((cols + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# NMS and the boxes of a line
# ---------------------------------------------------------------------------


def nms(boxes: np.ndarray, scores: np.ndarray, conf: float = CONF,
        iou: float = IOU, max_det: int = MAX_DET) -> np.ndarray:
    """Indices of the boxes kept, in score order: the ``max_det`` highest
    scores at or above ``conf`` (stable order among equal scores), each
    kept unless its IoU with a kept one exceeds ``iou``."""
    order = np.argsort(-scores, kind="stable")[:max_det]
    order = order[scores[order] >= conf]
    kept: List[int] = []
    for i in order:
        x1, y1, x2, y2 = boxes[i]
        area = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
        ok = True
        for j in kept:
            a1, b1, a2, b2 = boxes[j]
            inter = max(min(x2, a2) - max(x1, a1), 0.0) * \
                max(min(y2, b2) - max(y1, b1), 0.0)
            union = area + max(a2 - a1, 0.0) * max(b2 - b1, 0.0) - inter
            if inter / max(union, 1e-9) > iou:
                ok = False
                break
        if ok:
            kept.append(int(i))
    return np.asarray(kept, np.int64)


def line_boxes(boxes: np.ndarray, scores: np.ndarray, gain: float,
               pad: Tuple[int, int], shape: Tuple[int, int],
               conf: float = CONF, iou: float = IOU,
               max_det: int = MAX_DET) -> np.ndarray:
    """The kept boxes of one letterboxed line (:func:`nms`), mapped back
    to the line (``(xy - pad) / gain``, clipped to it), truncated to
    integers and sorted by their left edge: (N, 4) int."""
    keep = nms(boxes, scores, conf, iou, max_det)
    b = boxes[keep].astype(np.float32).copy()
    top, left = pad
    b[:, [0, 2]] = ((b[:, [0, 2]] - left) / gain).clip(0, shape[1])
    b[:, [1, 3]] = ((b[:, [1, 3]] - top) / gain).clip(0, shape[0])
    b = b.astype(np.int64)
    return b[np.argsort(b[:, 0], kind="stable")]


# ---------------------------------------------------------------------------
# the masked windows
# ---------------------------------------------------------------------------


def masked_window(img: np.ndarray, boxes: np.ndarray, j: int
                  ) -> Tuple[np.ndarray, int]:
    """``yolo_ocr_xloc.py``'s crop of the ``WINDOW`` boxes around box
    ``j``: (masked window uint8, index of its first box). The window's
    edge boxes are widened by ``EXPAND_EDGE`` px at the line's ends, each
    box's column band by ``EXPAND_PX``; outside the bands the window fades
    to the mean colour of its other pixels (truncated to uint8) through
    the blurred band mask."""
    n = len(boxes)
    start = 0 if n <= WINDOW else max(0, min(j - WINDOW // 2, n - WINDOW))
    idxs = range(start, min(n, start + WINDOW))
    x1 = min(int(boxes[i][0]) for i in idxs)
    x2 = max(int(boxes[i][2]) for i in idxs)
    if j == 0:
        x1 = max(x1 - EXPAND_EDGE, 0)
    if n - 1 in idxs:
        x2 = min(x2 + EXPAND_EDGE, img.shape[1])
    seg = img[:, x1:x2].copy()
    mask = np.zeros(seg.shape[:2], np.uint8)
    for i in idxs:
        lo = max(int(boxes[i][0]) - x1 - EXPAND_PX, 0)
        hi = min(int(boxes[i][2]) - x1 + EXPAND_PX, x2 - x1)
        mask[:, lo:hi] = 255
    other = mask == 0
    if other.any():
        colour = (seg[other].astype(np.float64).sum(0)
                  / other.sum()).astype(np.uint8)
    else:
        colour = np.full(3, 255, np.uint8)
    alpha = (gaussian_blur(mask).astype(np.float32) / 255.0)[..., None]
    out = seg * alpha + np.full(seg.shape, colour, np.uint8) * (1 - alpha)
    return out.astype(np.uint8), start


def recognizer_input(seg: np.ndarray, width: int) -> np.ndarray:
    """A masked window at the recognizer's input (32, ``width``, 3) uint8:
    height 32 with its aspect (at least 8 px, at most ``width``), then
    edge-padded on the right to ``width``."""
    h, w = seg.shape[:2]
    new_w = min(max(int(w * OCR_HEIGHT / h), 8), width)
    out = resize_linear(seg, new_w, OCR_HEIGHT)
    if new_w < width:
        out = np.pad(out, ((0, 0), (0, width - new_w), (0, 0)), mode="edge")
    return out


def normalize(segments: np.ndarray) -> np.ndarray:
    """uint8 recognizer inputs -> float32 in [-1, 1]."""
    return (segments.astype(np.float32) / 255.0 - 0.5) / 0.5


# ---------------------------------------------------------------------------
# the recognizer
# ---------------------------------------------------------------------------


def _ln(ctx, p, x):
    return F.layer_norm(x, (x.shape[-1],), ctx[f"{p}.weight"],
                        ctx[f"{p}.bias"], eps=LN_EPS)


def _ln_channels(ctx, p, x):
    return _ln(ctx, p, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def ocr_forward(ctx, x_nhwc: torch.Tensor, ocr: Dict) -> torch.Tensor:
    """x (B, 32, W, 3) in [-1, 1] -> CTC logits (B, W / 4, num_classes)."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    x = nets.conv(ctx, x, ctx["downsample_layers.0.0.weight"],
                  ctx["downsample_layers.0.0.bias"], stride=4)
    x = _ln_channels(ctx, "downsample_layers.0.1", x)
    for s, depth in enumerate(ocr["depths"]):
        if s:
            x = _ln_channels(ctx, f"downsample_layers.{s}.0", x)
            x = nets.conv(ctx, x, ctx[f"downsample_layers.{s}.1.weight"],
                          ctx[f"downsample_layers.{s}.1.bias"],
                          stride=(2, 1))
        for b in range(depth):
            p = f"stages.{s}.{b}"
            y = nets.conv(ctx, x, ctx[f"{p}.dwconv.weight"],
                          ctx[f"{p}.dwconv.bias"], padding=3,
                          groups=x.shape[1]).permute(0, 2, 3, 1)
            y = nets.lin(ctx, f"{p}.pwconv1", _ln(ctx, f"{p}.norm", y))
            y = nets.lin(ctx, f"{p}.pwconv2", F.gelu(y))
            x = x + (ctx[f"{p}.gamma"] * y).permute(0, 3, 1, 2)
    seq = x.mean(dim=2).transpose(1, 2)                 # (B, W / 4, C)
    pos = ctx["pos_embed"]
    if pos.shape[1] != seq.shape[1]:
        raise ValueError(f"{seq.shape[1]} frames against a positional "
                         f"embedding of {pos.shape[1]}")
    seq = seq + pos
    heads = ocr["vit_heads"]
    for i in range(ocr["vit_depth"]):
        p = f"blocks.{i}"
        b, n, d = seq.shape
        q, k, v = nets.lin(ctx, f"{p}.attn.qkv", _ln(ctx, f"{p}.norm1", seq)
                           ).reshape(b, n, 3, heads, d // heads).permute(
                               2, 0, 3, 1, 4).unbind(0)
        attn = torch.softmax(ctx.q(q) @ ctx.q(k).transpose(-2, -1)
                             * (d // heads) ** -0.5, dim=-1)
        y = (ctx.q(attn) @ ctx.q(v)).transpose(1, 2).reshape(b, n, d)
        seq = seq + nets.lin(ctx, f"{p}.attn.proj", y)
        y = nets.lin(ctx, f"{p}.mlp.fc1", _ln(ctx, f"{p}.norm2", seq))
        seq = seq + nets.lin(ctx, f"{p}.mlp.fc2", F.gelu(y))
    return nets.lin(ctx, "head", _ln(ctx, "norm", seq))


def ctc_text(ids: Sequence[int], chars: str, blank: int = 0) -> str:
    """Greedy CTC decode of one segment's per-frame ids: repeats merged,
    the blank dropped, id ``i`` -> ``chars[i]`` (ids past ``chars``
    dropped)."""
    out, prev = [], -1
    for t in ids:
        t = int(t)
        if t != prev and t != blank and t < len(chars):
            out.append(chars[t])
        prev = t
    return "".join(out)


def box_chars(texts: Sequence[str], starts: Sequence[int]) -> List[str]:
    """Each box's character: the ``j - start``-th of its window's text
    (its last character when shorter, '' when empty)."""
    return [t[min(j - s, len(t) - 1)] if t else ""
            for j, (t, s) in enumerate(zip(texts, starts))]


def center_locs(boxes: np.ndarray, height: int) -> List[float]:
    """float32 center locs of the boxes over the padded width 512 at the
    LQ height 32 (``test_sr.py:121-135``)."""
    return [float(np.float32((x1 + x2) / 2.0 * 32 / height / 512))
            for x1, _, x2, _ in boxes]
