"""Plain reference of the page server's host semantics.

What ``restore_page`` promises for a page with known text and character
boxes, written from the reference's ``test_sr.py`` (cubic resize to
height 32, zero pad to 512, [-1, 1]; locs from boxes) and the page
server's documented rules: crop each line box; split a line wider than
512 px at height 32 into ``ceil(w32 / 512)`` equal segments; give each
character to the segment that holds its box center (the first and last
segments also take centers left and right of the line); restore every
segment; show ``round(w * 128 / h)`` columns of each x4 output; pack to
uint8 as ``trunc(clip(x / 2 + 1 / 2, 0, 1) * 255 + 1 / 2)``; stitch the
segments of a line and concatenate their priors.

``resize_cubic_u8`` is a frozen copy of OpenCV's ``INTER_CUBIC`` for
uint8 images (``cv::resize`` without a vendor HAL), to the byte.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import nets

LQ_HEIGHT, LQ_WIDTH, SHOW_HEIGHT = 32, 512, 128
_ALPHABET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic", "alphabet.txt")

_CUBIC_A = np.float32(-0.75)
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_VEC = 8


def alphabet() -> str:
    with open(_ALPHABET, encoding="utf-8") as f:
        return f.read()


def _cubic_coeffs(fx: np.ndarray) -> np.ndarray:
    a, one = _CUBIC_A, np.float32(1)
    x = fx.astype(np.float32)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one)
          + np.float32(8) * a) * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _cubic_taps(n_out: int, n_in: int, inv_scale: float):
    scale = 1.0 / inv_scale
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    w = np.rint(_cubic_coeffs(f) * np.float32(_COEF_SCALE)).astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, w


def resize_cubic_u8(img: np.ndarray, factor: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=factor, fy=factor, INTER_CUBIC)`` of
    an (H, W, 3) uint8 image."""
    h, w = img.shape[:2]
    out_w, out_h = int(round(w * factor)), int(round(h * factor))
    if (out_h, out_w) == (h, w):
        return img.copy()
    c = img.shape[2]
    src = img.reshape(h, w * c).astype(np.int32)
    xi, xw = _cubic_taps(out_w, w, factor)
    yi, yw = _cubic_taps(out_h, h, factor)
    chan = np.arange(c)
    rows = sum(np.take(src, (xi[:, k, None] * c + chan).ravel(), axis=1)
               * np.repeat(xw[:, k].astype(np.int32), c) for k in range(4))
    n = out_w * c
    n_vec = n // _VEC * _VEC
    out = np.empty((out_h, n), np.int64)
    rows_f = rows[:, :n_vec].astype(np.float32)
    beta = yw.astype(np.float32) * np.float32(
        1.0 / (_COEF_SCALE * _COEF_SCALE))
    v = np.take(rows_f, yi[:, 3], axis=0) * beta[:, 3, None]
    for k in (2, 1, 0):
        v = np.take(rows_f, yi[:, k], axis=0) * beta[:, k, None] + v
    out[:, :n_vec] = np.rint(v)
    tail = sum(np.take(rows[:, n_vec:].astype(np.int64), yi[:, k], axis=0)
               * yw[:, k, None] for k in range(4))
    out[:, n_vec:] = (tail + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(out_h, out_w, c)


def split_line(img: np.ndarray) -> List[Tuple[np.ndarray, int]]:
    """[(segment, x offset)] of a line crop."""
    h, w = img.shape[:2]
    w32 = int(w * LQ_HEIGHT / h)
    if w32 <= LQ_WIDTH:
        return [(img, 0)]
    n = int(np.ceil(w32 / LQ_WIDTH))
    seg_w = int(np.ceil(w / n))
    return [(img[:, i * seg_w:(i + 1) * seg_w], i * seg_w) for i in range(n)]


def divide(text: str, boxes, segs) -> List[Tuple[str, list]]:
    """Each segment's characters and boxes (in segment coordinates)."""
    if len(segs) == 1:
        return [(text, list(boxes))]
    out = []
    for k, (seg, xoff) in enumerate(segs):
        seg_w = seg.shape[1]
        chars, bxs = [], []
        for ch, (x1, y1, x2, y2) in zip(text, boxes):
            c = (x1 + x2) / 2.0
            inside = xoff <= c < xoff + seg_w
            inside |= k == 0 and c < xoff
            inside |= k == len(segs) - 1 and c >= xoff + seg_w
            if inside:
                bxs.append((max(x1 - xoff, 0.0), y1,
                            min(x2 - xoff, float(seg_w)), y2))
                chars.append(ch)
        out.append(("".join(chars), bxs))
    return out


def prepare(seg: np.ndarray, text: str, boxes, chars: str):
    """(lq (32, 512, 3) f32 in [-1, 1], show width, labels, float32
    center locs) of one segment."""
    h = seg.shape[0]
    show_w = resize_cubic_u8(seg, SHOW_HEIGHT / h).shape[1]
    lq = resize_cubic_u8(seg, LQ_HEIGHT / h)
    canvas = np.zeros((LQ_HEIGHT, LQ_WIDTH, 3), np.uint8)
    canvas[:, :lq.shape[1]] = lq
    x = (canvas.astype(np.float32) / 255.0 - 0.5) / 0.5
    labels = [l for l in (chars.find(t) for t in text) if l >= 0]
    labels = labels[:nets.MAX_CHARS]
    return x, show_w, labels, centers_of(boxes, h, len(labels))


def centers_of(boxes, height: int, n: int) -> List[float]:
    """The float32 center locs of a segment's first ``n`` boxes, over the
    padded width at height 32."""
    return [float(np.float32((x1 + x2) / 2.0 * LQ_HEIGHT / height
                             / LQ_WIDTH))
            for x1, _, x2, _ in list(boxes)[:n]]


def segment_geometry(page: np.ndarray, line_boxes, texts, char_boxes
                     ) -> List[List[float]]:
    """Each segment's center locs, in page order, without preparing it."""
    out = []
    for (x1, y1, x2, y2), text, boxes in zip(line_boxes, texts, char_boxes):
        segs = split_line(page[y1:y2, x1:x2])
        for (seg, _), (t, b) in zip(segs, divide(text, boxes, segs)):
            out.append(centers_of(b, seg.shape[0],
                                  min(len(t), nets.MAX_CHARS)))
    return out


def pack_u8(x: torch.Tensor) -> np.ndarray:
    v = (x.float() * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0 + 0.5
    return v.to(torch.uint8).cpu().numpy()


def segments_of_page(page: np.ndarray, line_boxes, texts, char_boxes,
                     chars: Optional[str] = None):
    """Every segment of a page prepared, with each line's segment
    indices."""
    chars = alphabet() if chars is None else chars
    segs_out, groups = [], []
    for (x1, y1, x2, y2), text, boxes in zip(line_boxes, texts, char_boxes):
        segs = split_line(page[y1:y2, x1:x2])
        idxs = []
        for (seg, _), (t, b) in zip(segs, divide(text, boxes, segs)):
            idxs.append(len(segs_out))
            segs_out.append(prepare(seg, t, b, chars))
        groups.append(idxs)
    return segs_out, groups


def restore_page(ctxs, page: np.ndarray, line_boxes: Sequence,
                 texts: Sequence[str], char_boxes: Sequence,
                 device, block: int = 8):
    """[(sr uint8 (128, W, 3), text, priors uint8 (n, 128, 128, 3))] per
    line box, in float32 (or the control's rounding in each ``Ctx.q``);
    ``ctxs``: the encoder's, prior's and SR net's contexts by name."""
    chars = alphabet()
    segs, groups = segments_of_page(page, line_boxes, texts, char_boxes,
                                    chars)
    lq = torch.from_numpy(np.stack([s[0] for s in segs])).to(device)
    with torch.no_grad():
        sr, priors = nets.restore_lines(ctxs, lq, [s[2] for s in segs],
                                        [s[3] for s in segs], block=block)
    out = []
    for idxs in groups:
        srs = [pack_u8(sr[j, :, :segs[j][1]]) for j in idxs]
        pri = [pack_u8(priors[j]) for j in idxs]
        text = "".join(chars[l] for j in idxs for l in segs[j][2])
        out.append((np.concatenate(srs, axis=1), text,
                    np.concatenate(pri, axis=0)))
    return out
