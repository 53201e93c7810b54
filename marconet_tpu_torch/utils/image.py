"""Host-side image pre/post-processing, without cv2.

Counterpart of ``marconet_tpu/utils/image.py``, which calls cv2 for the
reference's preprocessing (``test_sr.py:98-115``: cubic resize to height
32, zero-pad to width 512, scale to [-1, 1]). The card's machine has no
cv2, so the resizes are written here in numpy:

* :func:`resize_cubic_u8` is OpenCV's own ``INTER_CUBIC`` for uint8
  images (``cv::resize`` without a vendor HAL), to the byte;
* :func:`resize_linear` is its ``INTER_LINEAR`` for float images.

The SSIM's Gaussian window is applied as a separable sum over the valid
region, which is all the metric keeps of cv2's ``filter2D``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

LQ_HEIGHT = 32
LQ_WIDTH = 512
SR_SCALE = 4
SHOW_HEIGHT = 128
MAX_WIDTH = SHOW_HEIGHT * 16  # 2048

_CUBIC_A = np.float32(-0.75)
_COEF_BITS = 11                     # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_VEC = 8   # elements per step of OpenCV's baseline (SSE) vertical pass


def _cubic_coeffs(fx: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` (A = -0.75), in f32: (n,) -> (n, 4)."""
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
    """Source indices (n_out, 4), clamped to the edge, and their 11-bit
    fixed-point weights (n_out, 4) for one axis."""
    scale = 1.0 / inv_scale
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    # saturate_cast<short>(c * 2048): round half to even
    w = np.rint(_cubic_coeffs(f) * np.float32(_COEF_SCALE)).astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, w


def resize_cubic_u8(img: np.ndarray, factor: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=factor, fy=factor,
    interpolation=cv2.INTER_CUBIC)`` for an (H, W, C) uint8 image.

    OpenCV's own algorithm: output size ``cvRound(W * factor)`` by
    ``cvRound(H * factor)``; half-pixel source coordinates; A = -0.75; edge
    indices clamped; no antialiasing when shrinking; weights rounded to 11
    bits. The horizontal pass sums in integers; the vertical pass, like
    OpenCV's SSE code, scales the integer rows by the weights / 2**22 in
    f32 and rounds half to even, except for the last ``width * C % 8``
    values of each row, which take its integer path (add 2**21, shift by
    22). Both saturate to [0, 255].
    """
    h, w = img.shape[:2]
    out_w, out_h = int(round(w * factor)), int(round(h * factor))
    if (out_h, out_w) == (h, w):
        return img.copy()
    c = img.reshape(h, w, -1).shape[2]
    src = img.reshape(h, w * c).astype(np.int32)
    xi, xw = _cubic_taps(out_w, w, factor)
    yi, yw = _cubic_taps(out_h, h, factor)
    # horizontal: exact integer sums over the 4 taps, (h, out_w * C)
    chan = np.arange(c)
    rows = sum(np.take(src, (xi[:, k, None] * c + chan).ravel(), axis=1)
               * np.repeat(xw[:, k].astype(np.int32), c)
               for k in range(4))
    n = out_w * c
    n_vec = n // _VEC * _VEC
    out = np.empty((out_h, n), np.int64)
    # vertical, f32 part: t0*b0 + (t1*b1 + (t2*b2 + t3*b3)), half to even
    rows_f = rows[:, :n_vec].astype(np.float32)
    beta = yw.astype(np.float32) * np.float32(
        1.0 / (_COEF_SCALE * _COEF_SCALE))
    v = np.take(rows_f, yi[:, 3], axis=0) * beta[:, 3, None]
    for k in (2, 1, 0):
        v = np.take(rows_f, yi[:, k], axis=0) * beta[:, k, None] + v
    out[:, :n_vec] = np.rint(v)
    # vertical, integer part: the last n % 8 values of each row
    tail = sum(np.take(rows[:, n_vec:].astype(np.int64), yi[:, k], axis=0)
               * yw[:, k, None] for k in range(4))
    out[:, n_vec:] = (tail + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((out_h, out_w) + img.shape[2:])


def _linear_taps(n_out: int, n_in: int):
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    left, right = s < 0, s >= n_in - 1
    f[left], s[left] = 0.0, 0
    f[right], s[right] = 0.0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1) - f, f


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (``INTER_LINEAR``) for an
    (H, W, C) float image: half-pixel coordinates, f32 weights, each edge
    clamped with weight 1, horizontal pass then vertical, in the image's
    own float type."""
    h, w = img.shape[:2]
    dt = img.dtype
    x0, x1, a0, a1 = _linear_taps(out_w, w)
    row = img[:, x0] * a0[None, :, None].astype(dt) \
        + img[:, x1] * a1[None, :, None].astype(dt)
    y0, y1, b0, b1 = _linear_taps(out_h, h)
    return row[y0] * b0[:, None, None].astype(dt) \
        + row[y1] * b1[:, None, None].astype(dt)


def preprocess_line(img_rgb: np.ndarray):
    """RGB uint8 (H, W, 3) -> model input + display copies.

    Returns (lq (1, 32, 512, 3) float32 in [-1, 1], show_lq (128, 4W', 3)
    uint8, ori_lq_width) or None when the line is wider than 512 at height
    32 (the reference warns and skips, ``test_sr.py:104-110``).
    """
    h = img_rgb.shape[0]
    show = resize_cubic_u8(img_rgb, SHOW_HEIGHT / h)
    lq = resize_cubic_u8(img_rgb, LQ_HEIGHT / h)
    ori_w = lq.shape[1]
    if ori_w > LQ_WIDTH:
        return None
    canvas = np.zeros((LQ_HEIGHT, LQ_WIDTH, 3), lq.dtype)
    canvas[:, :ori_w] = lq
    x = canvas.astype(np.float32) / 255.0
    x = (x - 0.5) / 0.5
    return x[None], show, ori_w


def lq_width(height: int, width: int) -> int:
    """The width :func:`preprocess_line` resizes an ``height`` x ``width``
    line to (``cvRound(width * 32 / height)``), without resizing."""
    return int(round(width * (LQ_HEIGHT / height)))


def postprocess_sr(sr: np.ndarray, show_width: int) -> np.ndarray:
    """(128, 2048, 3) in [-1, 1] -> RGB float [0, 255], cropped to content."""
    img = np.clip(sr * 0.5 + 0.5, 0, 1) * 255.0
    return img[:, :show_width]


def normalized_locs_from_boxes(boxes: Sequence[Sequence[float]],
                               src_height: int) -> np.ndarray:
    """xyxy character boxes (original image coords) -> (2N,) normalized
    (center, half-width) locs at the height-32 geometry, over the padded
    width (reference ``test_sr.py:121-135``)."""
    locs = np.zeros(2 * len(boxes), np.float32)
    for i, (x1, _, x2, _) in enumerate(boxes):
        center = (x1 + x2) / 2.0 * LQ_HEIGHT / src_height
        half = (x2 - x1) / 2.0 * LQ_HEIGHT / src_height
        locs[2 * i] = center / LQ_WIDTH
        locs[2 * i + 1] = half / LQ_WIDTH
    return locs


def draw_boxes(show_lq: np.ndarray, locs: np.ndarray,
               n_chars: int) -> np.ndarray:
    """Box markers over the display copy (reference ``test_sr.py:214-231``):
    red verticals at x = center - width on the top half, blue at
    x = center + width on the bottom half."""
    img = show_lq.copy()
    w_max = MAX_WIDTH
    for c in range(n_chars):
        center = int(locs[2 * c] * w_max)
        width = int(locs[2 * c + 1] * w_max)
        x, y = center - width, center + width
        xs = slice(max(0, x - 2), min(x + 2, w_max))
        ys = slice(max(0, y - 1), min(y + 1, w_max))
        img[:64, xs, :] = [255, 0, 0]
        img[64:, ys, :] = [0, 0, 255]
    return img


def stack_collage(show_lq: np.ndarray, show_locs: np.ndarray,
                  show_sr: np.ndarray, priors: np.ndarray,
                  n_chars: int) -> np.ndarray:
    """4-row collage, RGB: LQ / box overlay / SR / glyph priors (reference
    ``test_sr.py:204-232``)."""
    width = show_lq.shape[1]
    prior_row = np.concatenate([priors[i] for i in range(n_chars)], axis=1) \
        if n_chars else np.zeros((128, width, 3), np.float32)
    prior_row = np.clip(prior_row * 0.5 + 0.5, 0, 1)
    prior_row = resize_linear(prior_row, width, show_lq.shape[0]) * 255.0
    rows = [show_lq.astype(np.float32), show_locs.astype(np.float32),
            show_sr.astype(np.float32), prior_row.astype(np.float32)]
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# metrics (reference Train/util/utils_image.py:622,643)
# ---------------------------------------------------------------------------


def calculate_psnr(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """PSNR on uint8-scale images (reference ``utils_image.py:622-639``)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if border:
        img1 = img1[border:-border, border:-border]
        img2 = img2[border:-border, border:-border]
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """``cv2.getGaussianKernel(size, sigma)`` as a 1-D float64 array."""
    x = np.arange(size) - (size - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The separable window ``outer(k, k)`` over every full placement:
    ``cv2.filter2D(img, -1, outer(k, k))[r:-r, r:-r]``, r = len(k) // 2."""
    view = np.lib.stride_tricks.sliding_window_view
    rows = view(img, len(k), axis=0) @ k
    return view(rows, len(k), axis=1) @ k


def _ssim_channel(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_window()
    mu1 = _filter_valid(img1, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter_valid(img1 ** 2, k) - mu1_sq
    s2 = _filter_valid(img2 ** 2, k) - mu2_sq
    s12 = _filter_valid(img1 * img2, k) - mu1_mu2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(m.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray,
                   border: int = 0) -> float:
    """SSIM (reference ``utils_image.py:643-676``)."""
    if border:
        img1 = img1[border:-border, border:-border]
        img2 = img2[border:-border, border:-border]
    if img1.ndim == 2:
        return _ssim_channel(img1, img2)
    return float(np.mean([_ssim_channel(img1[..., c], img2[..., c])
                          for c in range(img1.shape[2])]))
