"""JPEG compress -> decompress round trip in numpy (the data workers' JPEG).

Counterpart of ``marconet_tpu/data/degrade/diffjpeg.py::jpeg_np`` with its
tables, the same arithmetic: RGB -> YCbCr, 2x2 chroma average pooling,
8x8 block DCT, quantisation with the standard luma / chroma tables scaled
by quality, the inverse chain with nearest chroma upsampling, and padding
to a multiple of 16. This is what the JAX package's
``data/native.py::jpeg_roundtrip`` computes (in C++ when its helper is
built). The JAX package's differentiable ``diff_jpeg`` is on no data path
and has no counterpart here yet.
"""

from __future__ import annotations

import numpy as np

# standard JPEG quantization tables
_Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32).T  # stored transposed: the reference's torch DiffJPEG
# convention (Train/util/diffjpeg.py y_table), kept for parity

_C_TABLE = np.full((8, 8), 99, np.float32)
_C_TABLE[:4, :4] = np.array([
    [17, 18, 24, 47],
    [18, 21, 26, 66],
    [24, 26, 56, 99],
    [47, 66, 99, 99]], np.float32)

_RGB2YCC = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312]], np.float32).T
_YCC_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)

_YCC2RGB = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0]], np.float32).T


def _dct_matrix() -> np.ndarray:
    d = np.zeros((8, 8), np.float32)
    for u in range(8):
        a = np.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            d[u, x] = 0.5 * a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d


_DCT = _dct_matrix()


def quality_to_factor(quality: float) -> float:
    """JPEG quality in (0, 100] -> quantisation scale factor."""
    q = float(quality)
    return ((5000.0 / q) if q < 50.0 else (200.0 - 2.0 * q)) / 100.0


def _channel_pass_np(ch, table, factor):
    h, w = ch.shape
    d = _DCT
    x = ch.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
    coef = np.einsum("ux,nmxy,vy->nmuv", d, x, d)
    q = table * factor
    coef = np.round(coef / q) * q
    rec = np.einsum("ux,nmuv,vy->nmxy", d, coef, d) + 128.0
    return rec.transpose(0, 2, 1, 3).reshape(h, w)


def jpeg_np(img: np.ndarray, quality: float) -> np.ndarray:
    """JPEG round trip of one (H, W, 3) RGB [0, 1] image -> float32."""
    h, w = img.shape[:2]
    hp, wp = (16 - h % 16) % 16, (16 - w % 16) % 16
    x = np.pad(img.astype(np.float32), ((0, hp), (0, wp), (0, 0)))
    factor = quality_to_factor(quality)

    ycc = (x * 255.0) @ _RGB2YCC + _YCC_SHIFT
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    hh, ww = y.shape

    def down(c):
        return c.reshape(hh // 2, 2, ww // 2, 2).mean(axis=(1, 3))

    def up(c):
        return np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)

    y = _channel_pass_np(y, _Y_TABLE, factor)
    cb = up(_channel_pass_np(down(cb), _C_TABLE, factor))
    cr = up(_channel_pass_np(down(cr), _C_TABLE, factor))
    out = (np.stack([y, cb, cr], -1) - _YCC_SHIFT) @ _YCC2RGB / 255.0
    return np.clip(out, 0.0, 1.0)[:h, :w].astype(np.float32)
