"""Image utilities for the data pipelines (counterpart of
``marconet_tpu/data/imutils.py``, pure numpy, the same arithmetic).

Numpy equivalents of the KAIR helpers the reference vendors
(``Train/util/utils_image.py``): MATLAB-convention bicubic resize
(``imresize_np``, ``:840``), uint/float converters (``:250-341``),
geometric augmentation modes (``:381-470``), and RGB<->YCbCr (``:530-597``).
PSNR/SSIM live in ``marconet_tpu_torch.utils.image``.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((np.clip(img, 0, 1) * 255.0).round())


# ---------------------------------------------------------------------------
# MATLAB bicubic resize
# ---------------------------------------------------------------------------


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) +
            (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((1 < ax) & (ax <= 2)))


def _resize_weights(in_len: int, out_len: int, scale: float):
    """Contribution indices/weights for one dimension (MATLAB imresize
    convention: antialiased kernel when shrinking)."""
    if scale < 1:
        kernel_width = 4.0 / scale
    else:
        kernel_width = 4.0
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - (idx + 1)
    if scale < 1:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / w.sum(axis=1, keepdims=True)
    # clamp out-of-range indices (replicate border)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    # drop all-zero weight columns
    keep = ~np.all(w == 0, axis=0)
    return idx[:, keep], w[:, keep]


def imresize_np(img: np.ndarray, scale: float,
                antialiasing: bool = True) -> np.ndarray:
    """MATLAB-convention bicubic resize of an (H, W[, C]) float image."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))

    eff_scale_h = scale if antialiasing else max(scale, 1.0)
    idx_h, w_h = _resize_weights(h, oh, eff_scale_h if scale < 1
                                 else scale)
    out = np.einsum("ok,okwc->owc", w_h,
                    img[idx_h.reshape(-1)].reshape(oh, -1, w, c))
    idx_w, w_w = _resize_weights(w, ow, scale)
    out = np.einsum("ok,hokc->hoc", w_w,
                    out[:, idx_w.reshape(-1)].reshape(oh, ow, -1, c))
    out = out.astype(img.dtype)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# augmentation + color
# ---------------------------------------------------------------------------


def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """8 flip/rotate modes (KAIR convention)."""
    if mode == 0:
        return img
    if mode == 1:
        return np.flipud(np.rot90(img))
    if mode == 2:
        return np.flipud(img)
    if mode == 3:
        return np.rot90(img, k=3)
    if mode == 4:
        return np.flipud(np.rot90(img, k=2))
    if mode == 5:
        return np.rot90(img)
    if mode == 6:
        return np.rot90(img, k=2)
    if mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(mode)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """ITU-R 601 full-swing-in/studio-swing-out (MATLAB rgb2ycbcr), on
    [0,1] float or uint8 input."""
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img *= 255.0
    if only_y:
        out = img @ np.array([65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = img @ np.array([[65.481, -37.797, 112.0],
                              [128.553, -74.203, -93.786],
                              [24.966, 112.0, -18.214]]) / 255.0 \
            + np.array([16, 128, 128])
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img *= 255.0
    mat = np.array([[0.00456621, 0.00456621, 0.00456621],
                    [0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0]]) * 255.0
    out = img @ mat + np.array([-222.921, 135.576, -276.836])
    if in_type == np.uint8:
        return np.clip(out, 0, 255).round().astype(np.uint8)
    return (np.clip(out, 0, 255) / 255.0).astype(in_type)
