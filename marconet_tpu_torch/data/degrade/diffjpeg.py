"""JPEG compress -> decompress round trips (counterpart of
``marconet_tpu/data/degrade/diffjpeg.py``).

Both follow the reference's torch DiffJPEG (``Train/util/diffjpeg.py``)
with its tables: RGB -> YCbCr, 2x2 chroma average pooling, 8x8 block DCT,
quantisation with the standard luma / chroma tables scaled by quality, the
inverse chain with nearest chroma upsampling, and padding to a multiple
of 16.

* :func:`jpeg_np`: one image in numpy, the data workers' JPEG (what the
  JAX package's ``data/native.py::jpeg_roundtrip`` computes).
* :func:`diff_jpeg`: a batch of NHWC tensors in torch on any device, with
  the cubic soft-rounding surrogate ``round(x) + (x - round(x)) ** 3``
  when ``differentiable``, so that autograd carries gradients through the
  quantisation. It is on no data path of the port, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# batched, differentiable round trip in torch
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, differentiable: bool) -> torch.Tensor:
    r = torch.round(x)                       # half to even, as jnp.round
    return r + (x - r) ** 3 if differentiable else r


def _blockify(ch: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, blocks, 8, 8)."""
    b, h, w = ch.shape
    x = ch.reshape(b, h // 8, 8, w // 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = blocks.shape[0]
    x = blocks.reshape(b, h // 8, w // 8, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _channel_pass(ch, table, factor, differentiable: bool):
    """DCT -> quantise -> dequantise -> inverse DCT of one (B, H, W)
    plane."""
    h, w = ch.shape[1:]
    d = torch.as_tensor(_DCT, device=ch.device)
    blocks = _blockify(ch) - 128.0
    coef = torch.einsum("ux,bnxy,vy->bnuv", d, blocks, d)
    q = table[None, None] * factor[:, None, None, None]
    coef = _round(coef / q, differentiable) * q
    rec = torch.einsum("ux,bnuv,vy->bnxy", d, coef, d) + 128.0
    return _unblockify(rec, h, w)


def _jpeg_core(x, factor, differentiable: bool):
    """x: (B, H, W, 3) in [0, 1], H and W multiples of 16."""
    b, h, w, _ = x.shape
    dev = x.device
    ycc = (x * 255.0) @ torch.as_tensor(_RGB2YCC, device=dev) \
        + torch.as_tensor(_YCC_SHIFT, device=dev)
    y, cb, cr = ycc.unbind(-1)

    def down(c):                              # 2x2 average pool
        return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def up(c):                                # nearest 2x upsample
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    yt = torch.as_tensor(_Y_TABLE, device=dev)
    ct = torch.as_tensor(_C_TABLE, device=dev)
    y = _channel_pass(y, yt, factor, differentiable)
    cb = up(_channel_pass(down(cb), ct, factor, differentiable))
    cr = up(_channel_pass(down(cr), ct, factor, differentiable))
    ycc = torch.stack([y, cb, cr], dim=-1) \
        - torch.as_tensor(_YCC_SHIFT, device=dev)
    rgb = ycc @ torch.as_tensor(_YCC2RGB, device=dev) / 255.0
    return rgb.clamp(0.0, 1.0)


def diff_jpeg(x: torch.Tensor, quality, differentiable: bool = False
              ) -> torch.Tensor:
    """JPEG round trip of a batch.

    Args:
      x: (B, H, W, 3) NHWC float tensor in [0, 1].
      quality: a number or (B,) qualities in (0, 100].
      differentiable: use the cubic soft-rounding surrogate.
    """
    x = x.float()
    b, h, w, _ = x.shape
    q = torch.as_tensor(quality, dtype=torch.float32,
                        device=x.device).expand(b)
    factor = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q) / 100.0
    hp, wp = (16 - h % 16) % 16, (16 - w % 16) % 16
    xp = F.pad(x, (0, 0, 0, wp, 0, hp))
    return _jpeg_core(xp, factor, differentiable)[:, :h, :w, :]
