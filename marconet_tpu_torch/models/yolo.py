"""YOLO11 character detector (counterpart of ``marconet_tpu/models/yolo.py``).

The reference detects character boxes with ultralytics YOLO-11m
(``yolo11m_character.pt``; conf 0.07, iou 0.1, imgsz 640). This is the
published YOLO11 architecture at scale m (depth 0.5, width 1.0, max
channels 512, one class): Conv-BN-SiLU stem, C3k2 CSP stages, SPPF, a
C2PSA attention stage, an FPN / PAN neck and an anchor-free Detect head
decoded with DFL, then a static-shape NMS.

Modules carry ultralytics' own key names (``model.{i}.*`` over the
yolo11.yaml layer list, ``model.23`` the Detect head), so a state dict
exported from ultralytics loads with a strict ``load_state_dict`` after
:func:`marconet_tpu_torch.convert.load_yolo_checkpoint` unwraps it. No
TPU kernel is on this path: convolutions are cuDNN's, PSA attention is a
plain matmul + softmax as in the JAX module. Tensors inside are NCHW in
``channels_last``; the public input is NHWC like the JAX module's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from marconet_tpu_torch.ops.layers import Conv, lecun_normal_

REG_MAX = 16
BN_EPS = 1e-3       # ultralytics BatchNorm2d(eps=0.001), as the JAX module


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (running statistics) with ``nn.BatchNorm2d``'s
    keys but no ``num_batches_tracked`` (the loader drops that counter)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


class ConvBNAct(nn.Module):
    """Conv (no bias) + BatchNorm + SiLU (ultralytics ``Conv``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(c2, c1 // g, k, k,
                                                    device=device))
        lecun_normal_(self.conv.weight, c1 // g * k * k, generator)
        self.bn = BatchNorm(c2, device=device)
        self.stride, self.groups, self.act = s, g, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        y = self.bn(F.conv2d(x, w, stride=self.stride,
                             padding=w.shape[-1] // 2, groups=self.groups))
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True, e: float = 0.5,
                 k: int = 3, **kw):
        super().__init__()
        c_ = int(c * e)
        self.cv1 = ConvBNAct(c, c_, k, **kw)
        self.cv2 = ConvBNAct(c_, c, k, **kw)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP block with three convs around two 3x3 bottlenecks."""

    def __init__(self, c: int, n: int = 2, shortcut: bool = True, **kw):
        super().__init__()
        c_ = c // 2
        self.cv1 = ConvBNAct(c, c_, **kw)
        self.cv2 = ConvBNAct(c, c_, **kw)
        self.cv3 = ConvBNAct(2 * c_, c, **kw)
        self.m = nn.Sequential(*(Bottleneck(c_, shortcut, e=1.0, **kw)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """YOLO11 CSP stage: split, n inner blocks (C3k or Bottleneck), fuse
    the concatenation of all parts."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True, **kw):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBNAct(c1, 2 * c_, **kw)
        self.cv2 = ConvBNAct((2 + n) * c_, c2, **kw)
        self.m = nn.ModuleList(
            C3k(c_, 2, shortcut, **kw) if c3k else
            Bottleneck(c_, shortcut, e=0.5, **kw) for _ in range(n))

    def forward(self, x):
        parts = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5, **kw):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBNAct(c1, c_, **kw)
        self.cv2 = ConvBNAct(4 * c_, c2, **kw)
        self.k = k

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.k, stride=1,
                                     padding=self.k // 2))
        return self.cv2(torch.cat(outs, 1))


class PSAAttention(nn.Module):
    """Position-sensitive attention (ultralytics ``Attention``): plain
    matmul + softmax, as the JAX module."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5,
                 **kw):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        total = num_heads * (2 * self.key_dim + self.head_dim)
        self.qkv = ConvBNAct(dim, total, act=False, **kw)
        self.proj = ConvBNAct(dim, dim, act=False, **kw)
        self.pe = ConvBNAct(dim, dim, 3, g=dim, act=False, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        q, k, v = self.qkv(x).reshape(b, nh, 2 * kd + hd, h * w).split(
            [kd, kd, hd], dim=2)
        attn = torch.softmax((q.transpose(-2, -1) @ k) * (kd ** -0.5), -1)
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        out = out + self.pe(v.reshape(b, c, h, w))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.attn = PSAAttention(c, num_heads=c // 64, **kw)
        self.ffn = nn.Sequential(ConvBNAct(c, 2 * c, **kw),
                                 ConvBNAct(2 * c, c, act=False, **kw))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, **kw):
        super().__init__()
        self.c = c1 // 2
        self.cv1 = ConvBNAct(c1, 2 * self.c, **kw)
        self.cv2 = ConvBNAct(2 * self.c, c2, **kw)
        self.m = nn.Sequential(*(PSABlock(self.c, **kw) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class DetectHead(nn.Module):
    """Anchor-free Detect head; returns each level's raw box logits
    (B, 4 * REG_MAX, H, W) and class logits (B, nc, H, W)."""

    def __init__(self, nc: int = 1, ch: Sequence[int] = (256, 512, 512),
                 **kw):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        conv = dict(device=kw["device"], generator=kw["generator"])
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBNAct(c, c2, 3, **kw), ConvBNAct(c2, c2, 3, **kw),
            Conv(c2, 4 * REG_MAX, 1, **conv)) for c in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(ConvBNAct(c, c, 3, g=c, **kw),
                          ConvBNAct(c, c3, 1, **kw)),
            nn.Sequential(ConvBNAct(c3, c3, 3, g=c3, **kw),
                          ConvBNAct(c3, c3, 1, **kw)),
            Conv(c3, nc, 1, **conv)) for c in ch)

    def forward(self, feats: List[torch.Tensor]):
        return ([m(x) for m, x in zip(self.cv2, feats)],
                [m(x) for m, x in zip(self.cv3, feats)])


class _NoParams(nn.Module):
    """Holds the index of a parameterless yolo11.yaml layer (Upsample,
    Concat) so the others keep ultralytics' ``model.{i}`` keys."""


class YOLO11(nn.Module):
    """YOLO11 at scale m (depth 0.5, width 1.0, max channels 512).

    Args:
      nc: class count (1: the reference's character detector).
      device: where parameters are created.
      generator: the ``torch.Generator`` that draws the random init
        (lecun-normal convs; BatchNorm at identity, as flax inits it).
    """

    strides = (8, 16, 32)

    def __init__(self, nc: int = 1, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.nc = nc
        self.model = nn.ModuleList([
            ConvBNAct(3, 64, 3, 2, **kw),                       # 0
            ConvBNAct(64, 128, 3, 2, **kw),                     # 1
            C3k2(128, 256, 1, False, 0.25, **kw),               # 2
            ConvBNAct(256, 256, 3, 2, **kw),                    # 3
            C3k2(256, 512, 1, False, 0.25, **kw),               # 4
            ConvBNAct(512, 512, 3, 2, **kw),                    # 5
            C3k2(512, 512, 1, True, **kw),                      # 6
            ConvBNAct(512, 512, 3, 2, **kw),                    # 7
            C3k2(512, 512, 1, True, **kw),                      # 8
            SPPF(512, 512, 5, **kw),                            # 9
            C2PSA(512, 512, 1, **kw),                           # 10
            _NoParams(), _NoParams(),                           # 11, 12
            C3k2(1024, 512, 1, False, **kw),                    # 13
            _NoParams(), _NoParams(),                           # 14, 15
            C3k2(1024, 256, 1, False, **kw),                    # 16
            ConvBNAct(256, 256, 3, 2, **kw),                    # 17
            _NoParams(),                                        # 18
            C3k2(768, 512, 1, False, **kw),                     # 19
            ConvBNAct(512, 512, 3, 2, **kw),                    # 20
            _NoParams(),                                        # 21
            C3k2(1024, 512, 1, True, **kw),                     # 22
            DetectHead(nc, (256, 512, 512), **kw),              # 23
        ])
        self.eval()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) NHWC in [0, 1], H and W multiples of 32.

        Returns (pred_boxes (B, A, 4) xyxy in pixels, pred_scores
        (B, A, nc)), A the anchors of the three levels.
        """
        m = self.model
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x4 = m[4](m[3](m[2](m[1](m[0](x)))))
        x6 = m[6](m[5](x4))
        x10 = m[10](m[9](m[8](m[7](x6))))
        x13 = m[13](torch.cat([_up2x_nearest(x10), x6], 1))
        x16 = m[16](torch.cat([_up2x_nearest(x13), x4], 1))
        x19 = m[19](torch.cat([m[17](x16), x13], 1))
        x22 = m[22](torch.cat([m[20](x19), x10], 1))
        box_raw, cls_raw = m[23]([x16, x19, x22])
        return decode_dfl(box_raw, cls_raw, self.strides, self.nc)


def _up2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def decode_dfl(box_raw: List[torch.Tensor], cls_raw: List[torch.Tensor],
               strides: Sequence[int], nc: int):
    """Ultralytics Detect decode: DFL expectation + dist2bbox.

    Per level: (B, 4 * REG_MAX, H, W) raw box logits -> softmax over the 16
    bins (f32) -> expected distance -> xyxy around the (x + 0.5, y + 0.5)
    anchor grid, times the level's stride; (B, nc, H, W) class logits ->
    sigmoid. Anchors run row-major over each level, levels in order, as in
    the JAX ``decode_dfl`` (which takes the same logits NHWC).
    """
    boxes, scores = [], []
    for stride, braw, craw in zip(strides, box_raw, cls_raw):
        b, _, hh, ww = braw.shape
        dist = braw.permute(0, 2, 3, 1).reshape(b, hh * ww, 4, REG_MAX)
        bins = torch.arange(REG_MAX, dtype=torch.float32,
                            device=braw.device)
        dist = (torch.softmax(dist.float(), dim=-1) * bins).sum(-1)
        cy, cx = torch.meshgrid(
            torch.arange(hh, device=braw.device, dtype=torch.float32) + 0.5,
            torch.arange(ww, device=braw.device, dtype=torch.float32) + 0.5,
            indexing="ij")
        anchors = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)
        lt, rb = dist[..., :2], dist[..., 2:]
        boxes.append(torch.cat([(anchors - lt) * stride,
                                (anchors + rb) * stride], -1))
        scores.append(torch.sigmoid(
            craw.permute(0, 2, 3, 1).reshape(b, hh * ww, nc).float()))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def nms_static(boxes: torch.Tensor, scores: torch.Tensor,
               max_det: int = 100, iou_thresh: float = 0.1,
               conf_thresh: float = 0.07):
    """Static-shape class-agnostic NMS (the JAX ``nms_static``).

    boxes: (A, 4) xyxy; scores: (A,). Returns (boxes (max_det, 4), scores
    (max_det,), valid (max_det,)): the ``max_det`` best candidates by
    score (``torch.topk`` over the confidence-masked scores, -1 below
    ``conf_thresh``), with suppressed or low-confidence rows at score 0
    and valid 0.

    The (max_det, max_det) IoU matrix is computed on the scores' device;
    the greedy pass in score order runs on the host over the copied
    ``iou > iou_thresh`` matrix (10 KB at 100 candidates): it is
    ``max_det`` dependent steps of a few scalar operations, which on the
    card would be ``max_det`` tiny kernel launches, and the front-end
    copies the kept boxes to the host right after anyway.
    """
    masked = torch.where(scores >= conf_thresh, scores,
                         torch.full_like(scores, -1.0))
    top_scores, idx = torch.topk(masked, max_det)
    top = boxes[idx]
    x1, y1, x2, y2 = top.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    iw = (torch.minimum(x2[:, None], x2[None]) -
          torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) -
          torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    union = area[:, None] + area[None] - inter
    over = (inter / union.clamp(min=1e-9) > iou_thresh).cpu().numpy()
    live = (top_scores > 0).cpu().numpy()
    keep = np.zeros(max_det, bool)
    for i in range(max_det):
        keep[i] = live[i] and not (over[i, :i] & keep[:i]).any()
    keep_t = torch.from_numpy(keep).to(scores.device)
    return (top, torch.where(keep_t, top_scores,
                             torch.zeros_like(top_scores)),
            keep_t.float())
