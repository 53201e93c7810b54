"""Host-side image pre/post-processing, without cv2.

Counterpart of ``marconet_tpu/utils/image.py``, which calls cv2 for the
reference's preprocessing (``test_sr.py:98-115``: cubic resize to height
32, zero-pad to width 512, scale to [-1, 1]). The card's machine has no
cv2, so the resizes are written here in numpy:

* :func:`resize_cubic_u8` is OpenCV's own ``INTER_CUBIC`` for uint8
  images (``cv::resize`` without a vendor HAL), to the byte;
* :func:`resize_linear` is its ``INTER_LINEAR`` for float images, and
  :func:`resize_linear_u8` for uint8 ones;
* :func:`gaussian_blur_u8` is its ``GaussianBlur`` (sigma 0) for uint8
  images;
* :func:`resize` is ``cv::resize`` for float images in its four
  interpolations (``INTER_LINEAR``, ``INTER_CUBIC``, ``INTER_AREA``,
  ``INTER_LANCZOS4``, keyed by OpenCV's integer codes so that the data
  path draws the same codes from the same lists as the JAX package), and
  :func:`filter2d` its ``filter2D`` with ``BORDER_REFLECT_101``.

The SSIM's Gaussian window is applied as a separable sum over the valid
region, which is all the metric keeps of cv2's ``filter2D``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import signal

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


def resize_cubic_u8(img: np.ndarray, factor: Optional[float] = None,
                    size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=factor, fy=factor,
    interpolation=cv2.INTER_CUBIC)`` for an (H, W, C) uint8 image, or with
    ``size`` = (width, height) ``cv2.resize(img, size,
    interpolation=cv2.INTER_CUBIC)``.

    OpenCV's own algorithm: output size ``cvRound(W * factor)`` by
    ``cvRound(H * factor)`` (or ``size``, each axis scaled by its own
    ratio); half-pixel source coordinates; A = -0.75; edge
    indices clamped; no antialiasing when shrinking; weights rounded to 11
    bits. The horizontal pass sums in integers; the vertical pass, like
    OpenCV's SSE code, scales the integer rows by the weights / 2**22 in
    f32 and rounds half to even, except for the last ``width * C % 8``
    values of each row, which take its integer path (add 2**21, shift by
    22). Both saturate to [0, 255].
    """
    h, w = img.shape[:2]
    if size is None:
        out_w, out_h = int(round(w * factor)), int(round(h * factor))
        fx = fy = factor
    else:
        out_w, out_h = int(size[0]), int(size[1])
        fx, fy = out_w / w, out_h / h
    if (out_h, out_w) == (h, w):
        return img.copy()
    c = img.reshape(h, w, -1).shape[2]
    src = img.reshape(h, w * c).astype(np.int32)
    xi, xw = _cubic_taps(out_w, w, fx)
    yi, yw = _cubic_taps(out_h, h, fy)
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


def resize_linear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (``INTER_LINEAR``) for an
    (H, W, C) float image (:func:`resize`)."""
    return resize(img, (out_w, out_h), INTER_LINEAR)


def _linear_coeffs_u8(n_out: int, n_in: int, clamp: bool):
    """Source indices and 11-bit weights of one axis of OpenCV's uint8
    ``INTER_LINEAR``. Columns outside the source take the edge pixel
    with weight 2048 (``clamp``); rows keep their fractional weight over
    the edge row taken twice, as ``cv::resize`` does."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        left, right = s < 0, s >= n_in - 1
        f[left], s[left] = 0.0, 0
        f[right], s[right] = 0.0, n_in - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def resize_linear_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    for an (H, W, C) uint8 image, to the byte (``cv::resize`` without a
    vendor HAL): 11-bit weights, an exact integer horizontal pass, and the
    vertical pass of OpenCV's SIMD code, ``((b0 * (r0 >> 4)) >> 16) +
    ((b1 * (r1 >> 4)) >> 16)`` rounded by ``(v + 2) >> 2``."""
    h, w = img.shape[:2]
    c = img.reshape(h, w, -1).shape[2]
    x0, x1, a0, a1 = _linear_coeffs_u8(out_w, w, clamp=True)
    y0, y1, b0, b1 = _linear_coeffs_u8(out_h, h, clamp=False)
    src = img.reshape(h, w, c).astype(np.int64)
    rows = (src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
            ).reshape(h, out_w * c)
    v = (((b0[:, None] * (rows[y0] >> 4)) >> 16)
         + ((b1[:, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    out = np.clip(v, 0, 255).astype(np.uint8)
    return out.reshape((out_h, out_w) + img.shape[2:])


def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of ``n + 2 * pad`` positions under OpenCV's
    ``BORDER_REFLECT_101`` (``borderInterpolate``), folding repeatedly."""
    out = []
    for p in range(-pad, n + pad):
        while n > 1 and not 0 <= p < n:
            p = -p if p < 0 else 2 * n - p - 2
        out.append(p if n > 1 else 0)
    return np.asarray(out)


def _gaussian_kernel_u8(ksize: int) -> np.ndarray:
    """OpenCV's Gaussian kernel for ``sigma=0`` on uint8 images: the
    bit-exact float kernel (``sigma = 0.15 * ksize + 0.35``) in 8-bit
    fixed point, rounded with error diffusion from the tails in, the
    centre taking what makes the sum 256."""
    sigma = ksize * 0.15 + 0.35
    half = (ksize - 1) // 2
    vals = [np.exp(float(x * x) * (-0.125 / (sigma * sigma)))
            for x in range(1 - ksize, 1 - ksize + 2 * half, 2)]
    norm = 1.0 / (2.0 * sum(vals) + 1.0)
    k = np.zeros(ksize, np.int64)
    err = 0.0
    for i in range(half):
        adj = vals[i] * norm * 256.0 + err
        k[i] = k[ksize - 1 - i] = int(np.rint(adj))
        err = adj - k[i]
    k[half] = 256 - 2 * int(k[:half].sum())
    return k


def gaussian_blur_u8(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` for a 2-D uint8 image,
    to the byte: OpenCV's fixed-point path (8-bit kernel, integer row and
    column sums, rounded once), border ``BORDER_REFLECT_101``. ``ksize``
    is odd and at least 9 (below that OpenCV takes fixed tables)."""
    if ksize < 9 or ksize % 2 == 0:
        raise ValueError(f"ksize must be odd and >= 9, got {ksize}")
    h, w = img.shape
    k = _gaussian_kernel_u8(ksize)
    r = ksize // 2
    src = img.astype(np.int64)
    xi, yi = _reflect101(w, r), _reflect101(h, r)
    rows = sum(src[:, xi[j:j + w]] * k[j] for j in range(ksize))
    cols = sum(rows[yi[j:j + h]] * k[j] for j in range(ksize))
    return np.clip((cols + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


# OpenCV's interpolation codes (``cv2.INTER_*``)
INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = 1, 2, 3, 4
_LANCZOS_CS = ((1, 0), (-math.sqrt(0.5), -math.sqrt(0.5)), (0, 1),
               (math.sqrt(0.5), -math.sqrt(0.5)), (-1, 0),
               (math.sqrt(0.5), math.sqrt(0.5)), (0, -1),
               (-math.sqrt(0.5), math.sqrt(0.5)))


def _lanczos4_coeffs(fx: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4``: (n,) f32 -> (n, 8) f32 weights of
    the taps at ``sx - 3 .. sx + 4``, normalised by their f32 sum."""
    x3 = fx.astype(np.float32) + np.float32(3)
    y0 = -x3.astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    out = np.empty((len(fx), 8), np.float32)
    total = np.zeros(len(fx), np.float32)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        arg = x3 - np.float32(i)
        y = -arg.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            coef = ((cs * s0 + cc * c0) / (y * y)).astype(np.float32)
        out[:, i] = np.where(np.abs(arg) >= np.float32(1e-6), coef,
                             np.float32(1e30))
        total = total + out[:, i]
    return out * (np.float32(1) / total)[:, None]


def _interp_taps(n_out: int, n_in: int, mode: int, clamp_edges: bool):
    """Source indices (n_out, K), clipped to the image, and f32 weights
    (n_out, K) of one axis of ``cv::resize``'s separable path
    (``resizeGeneric``). ``INTER_AREA`` here is its upscaling form, a
    bilinear with OpenCV's clipped fractions. ``clamp_edges``: the
    horizontal axis, where OpenCV pins a linear tap that leaves the image
    to the edge pixel with weight 1 (the vertical axis keeps the weights
    and clips the rows)."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    d = np.arange(n_out, dtype=np.float64)
    if mode == INTER_AREA:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(
            np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    if mode in (INTER_LINEAR, INTER_AREA):
        if clamp_edges:
            left, right = s < 0, s >= n_in - 1
            f[left], s[left] = 0.0, 0
            f[right], s[right] = 0.0, n_in - 1
        w = np.stack([np.float32(1) - f, f], axis=-1)
    elif mode == INTER_CUBIC:
        w = _cubic_coeffs(f)
    elif mode == INTER_LANCZOS4:
        w = _lanczos4_coeffs(f)
    else:
        raise ValueError(f"unsupported interpolation {mode}")
    k = w.shape[1]
    idx = np.clip(s[:, None] + np.arange(k)[None, :] - (k // 2 - 1),
                  0, n_in - 1)
    return idx, w.astype(np.float32)


def _area_taps(n_out: int, n_in: int, scale: Optional[float] = None):
    """OpenCV's ``computeResizeAreaTab`` for a fractional downscale by
    ``scale`` source pixels an output pixel (default n_in / n_out), as
    (n_out, K) source indices and f32 weights (unused taps weigh 0)."""
    scale = n_in / n_out if scale is None else scale
    rows = []
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_out, k), np.int64)
    w = np.zeros((n_out, k), np.float32)
    for dx, taps in enumerate(rows):
        for j, (sx, a) in enumerate(taps):
            idx[dx, j], w[dx, j] = sx, np.float32(a)
    return idx, w


def _apply_taps(img: np.ndarray, idx: np.ndarray, w: np.ndarray,
                axis: int, nested: bool = False) -> np.ndarray:
    """sum_k w[:, k] * img[idx[:, k]] along ``axis`` (0 or 1) in the
    image's float type, in OpenCV's order: taps added left to right, or,
    with ``nested`` (the vertical cubic and Lanczos passes), as its
    4-lane SIMD code adds them, ``w0 x0 + (w1 x1 + (... + w7 x7))``, for
    all but the last ``n % 4`` values of each row."""
    shape = [1] * img.ndim
    shape[axis] = len(idx)
    terms = [np.take(img, idx[:, k], axis=axis)
             * w[:, k].astype(img.dtype).reshape(shape)
             for k in range(idx.shape[1])]
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    if nested:
        rows = [t.reshape(t.shape[0], -1) for t in terms]
        n4 = rows[0].shape[1] // 4 * 4
        acc = rows[-1][:, :n4]
        for row in rows[-2::-1]:
            acc = row[:, :n4] + acc
        out.reshape(out.shape[0], -1)[:, :n4] = acc
    return out


def _area_fast(img: np.ndarray, out_w: int, out_h: int, ix: int,
               iy: int) -> np.ndarray:
    """The mean of whole ``iy`` x ``ix`` blocks, summed as OpenCV's
    ``resizeAreaFast`` does: block pixels in raster order, four at a time
    (``sum += a + b + c + d``), times ``1 / area`` in f32; for one channel
    and 2 x 2 blocks its 4-lane SIMD code, ``(a + b + (c + d)) / 4``,
    on all but the last ``out_w % 4`` values of each row."""
    blocks = img.reshape((out_h, iy, out_w, ix) + img.shape[2:])
    parts = [blocks[:, sy, :, sx] for sy in range(iy) for sx in range(ix)]
    total = None
    k = 0
    while k <= len(parts) - 4:
        group = parts[k] + parts[k + 1] + parts[k + 2] + parts[k + 3]
        total = group if total is None else total + group
        k += 4
    for part in parts[k:]:
        total = part if total is None else total + part
    scale = img.dtype.type(1.0 / (ix * iy))
    out = total * scale
    if ix == iy == 2 and (img.ndim == 2 or img.shape[2] == 1):
        n4 = out_w // 4 * 4
        a, b, c, d = (p[:, :n4] for p in parts)
        out[:, :n4] = ((a + b) + (c + d)) * scale
    return out


def resize(img: np.ndarray, size: Tuple[int, int], mode: int
           ) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=mode)`` for an (H, W) or
    (H, W, C) float32 / float64 image (no vendor HAL).

    ``size`` is (width, height), ``mode`` an OpenCV code: ``INTER_LINEAR``
    (1), ``INTER_CUBIC`` (2, A = -0.75), ``INTER_AREA`` (3) or
    ``INTER_LANCZOS4`` (4, 8 taps). Half-pixel centres; taps beyond the
    image repeat its edge. As ``cv::resize``: an unchanged size copies; a
    linear halving of both sides is an area mean; ``INTER_AREA`` takes
    the mean of whole blocks when both scales are integers, OpenCV's
    area tables when both shrink, and otherwise a bilinear with clipped
    fractions. Horizontal pass first, then vertical, in the image's type.
    An empty image or size raises ``ValueError``, as cv2 does.
    """
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if h <= 0 or w <= 0 or out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize of a {img.shape} image to {size}")
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"resize takes float images, got {img.dtype}")
    if (out_w, out_h) == (w, h):
        return img.copy()
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    area_fast = (abs(scale_x - ix) < np.finfo(float).eps
                 and abs(scale_y - iy) < np.finfo(float).eps)
    if mode == INTER_LINEAR and area_fast and ix == 2 and iy == 2:
        mode = INTER_AREA
    if mode == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        if area_fast:
            return _area_fast(img, out_w, out_h, ix, iy)
        rows = _apply_taps(img, *_area_taps(out_w, w), axis=1)
        return _apply_taps(rows, *_area_taps(out_h, h), axis=0)
    rows = _apply_taps(img, *_interp_taps(out_w, w, mode, True), axis=1)
    return _apply_taps(rows, *_interp_taps(out_h, h, mode, False), axis=0,
                       nested=mode in (INTER_CUBIC, INTER_LANCZOS4))


def resize_area_u8(img: np.ndarray, factor: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=factor, fy=factor,
    interpolation=cv2.INTER_AREA)`` for an (H, W, C) uint8 image and a
    factor at most 1, to the byte.

    Output size ``cvRound(W * factor)`` by ``cvRound(H * factor)``; the
    source cell of an output pixel is ``1 / factor`` wide (not W / W'),
    as cv2 takes it from ``fx``. An integer ``1 / factor`` averages whole
    blocks: 2 x 2 blocks in integers rounded half up (OpenCV's SIMD
    path), larger ones as a sum times ``1 / area`` in f32 rounded half to
    even (its scalar path), and the blocks cut by the image's edge by
    their pixel count in f32, rounded half to even.
    Another factor goes through the f32 area tables of :func:`resize`
    with that cell width, rounded half to even.
    """
    h, w = img.shape[:2]
    c = img.reshape(h, w, -1).shape[2]
    out_w, out_h = int(round(w * factor)), int(round(h * factor))
    if (out_w, out_h) == (w, h):
        return img.copy()
    if factor > 1 or out_w <= 0 or out_h <= 0:
        raise ValueError(f"resize_area_u8 shrinks, got factor {factor} "
                         f"for a {img.shape} image")
    scale = 1.0 / factor
    k = int(round(scale))
    src = img.reshape(h, w, c)
    if abs(scale - k) >= np.finfo(float).eps:
        f = src.astype(np.float32)
        rows = _apply_taps(f, *_area_taps(out_w, w, scale), axis=1)
        out = _apply_taps(rows, *_area_taps(out_h, h, scale), axis=0)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8) \
            .reshape((out_h, out_w) + img.shape[2:])
    # pad to whole blocks; a pixel outside the image counts 0 times
    ph, pw = out_h * k, out_w * k
    padded = np.zeros((max(ph, h), max(pw, w), c), np.int64)
    padded[:h, :w] = src
    inside = np.zeros((max(ph, h), max(pw, w)), np.int64)
    inside[:h, :w] = 1
    sums = padded[:ph, :pw].reshape(out_h, k, out_w, k, c).sum((1, 3))
    counts = inside[:ph, :pw].reshape(out_h, k, out_w, k).sum((1, 3))
    area = k * k
    if k == 2:                 # the SIMD path: (a + b + c + d + 2) >> 2
        out = (sums + 2) >> 2
    else:                      # the scalar path: sum * (1 / area) in f32
        out = np.rint(sums.astype(np.float32) * np.float32(1.0 / area)) \
            .astype(np.int64)
    cut = counts < area
    part = sums[cut].astype(np.float32) / \
        np.repeat(counts[cut][:, None], c, 1).astype(np.float32)
    out[cut] = np.rint(part).astype(np.int64)
    return np.clip(out, 0, 255).astype(np.uint8) \
        .reshape((out_h, out_w) + img.shape[2:])


_DFT_FILTER_AREA = 130   # cv::filter2D correlates f32 by DFT from here


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel, borderType=cv2.BORDER_REFLECT_101)``
    for an (H, W) or (H, W, C) float32 image and an odd (k, k) float32
    kernel: a correlation (the kernel is not flipped) centred on each
    pixel, the border mirrored without repeating the edge.

    As OpenCV computes it: a kernel of 130 taps or more by FFT in float64
    (``scipy.signal.fftconvolve`` of the flipped kernel; OpenCV's DFT
    path also works in float64), a smaller one directly in float32, the
    nonzero taps in raster order, each fused-multiply-added into the sum
    (its 8-lane SIMD loop) except in the last ``n % 8`` values of a row,
    where product and sum round apart (its scalar loop).
    """
    kh, kw = kernel.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"filter2d takes an odd kernel, got {kernel.shape}")
    h, w = img.shape[:2]
    k32 = np.asarray(kernel, np.float32)
    x = np.take(np.take(img.astype(np.float64), _reflect101(h, kh // 2),
                        axis=0), _reflect101(w, kw // 2), axis=1)
    if kh * kw >= _DFT_FILTER_AREA:
        k = k32.astype(np.float64)[::-1, ::-1]
        if img.ndim == 3:
            k = k[:, :, None]
        out = signal.fftconvolve(x, k, mode="valid", axes=(0, 1))
        return out.astype(img.dtype)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    c = x.shape[2]
    n = w * c
    n8 = n // 8 * 8
    acc = np.zeros((h, n), np.float32)
    prod = np.empty((h, n), np.float64)
    head, tail = (slice(None), slice(0, n8)), (slice(None), slice(n8, n))
    for i, j in zip(*np.nonzero(k32)):
        np.multiply(x[i:i + h, j:j + w].reshape(h, n), np.float64(k32[i, j]),
                    out=prod)
        # exact product, one rounding of the sum: a fused multiply-add
        np.add(acc[head], prod[head], out=acc[head], casting="unsafe")
        acc[tail] += prod[tail].astype(np.float32)
    return acc.reshape(img.shape)


def lq_input(img_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3) -> the model input: the line resized to height
    32 (cubic), at the left of a zero 32 x 512 canvas, scaled to [-1, 1];
    (1, 32, 512, 3) float32. Raises ``ValueError`` for a line wider than
    512 at height 32."""
    lq = resize_cubic_u8(img_rgb, LQ_HEIGHT / img_rgb.shape[0])
    ori_w = lq.shape[1]
    if ori_w > LQ_WIDTH:
        raise ValueError("line wider than 512 after h=32 resize")
    canvas = np.zeros((LQ_HEIGHT, LQ_WIDTH, 3), lq.dtype)
    canvas[:, :ori_w] = lq
    x = canvas.astype(np.float32) / 255.0
    x = (x - 0.5) / 0.5
    return x[None]


def preprocess_line(img_rgb: np.ndarray):
    """RGB uint8 (H, W, 3) -> model input + display copies.

    Returns (lq (1, 32, 512, 3) float32 in [-1, 1] (:func:`lq_input`),
    show_lq (128, 4W', 3) uint8, ori_lq_width) or None when the line is
    wider than 512 at height 32 (the reference warns and skips,
    ``test_sr.py:104-110``).
    """
    h, w = img_rgb.shape[:2]
    ori_w = lq_width(h, w)
    if ori_w > LQ_WIDTH:
        return None
    show = resize_cubic_u8(img_rgb, SHOW_HEIGHT / h)
    return lq_input(img_rgb), show, ori_w


def lq_width(height: int, width: int) -> int:
    """The width :func:`preprocess_line` resizes an ``height`` x ``width``
    line to (``cvRound(width * 32 / height)``), without resizing."""
    return int(round(width * (LQ_HEIGHT / height)))


def show_width(height: int, width: int) -> int:
    """The width of :func:`preprocess_line`'s display copy of an
    ``height`` x ``width`` line (``cvRound(width * 128 / height)``, as
    :func:`resize_cubic_u8` sizes it), without resizing."""
    return int(round(width * (SHOW_HEIGHT / height)))


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
