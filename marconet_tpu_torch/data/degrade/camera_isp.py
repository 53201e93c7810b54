"""Camera ISP simulation: sRGB -> RAW -> noise -> sRGB (numpy; counterpart
of ``marconet_tpu/data/degrade/camera_isp.py``, whose one cv2 call, the
demosaic's bilinear x2, is :func:`marconet_tpu_torch.utils.image.resize`).

Behavioural port of the "Unprocessing Images for Learned Raw Denoising"
pipeline the reference vendors (``Train/util/unprocess.py`` /
``Train/util/process.py``, used via ``same_degradation.get_camera`` and the
BSRGAN isp hook): inverse tone curve + gamma, random CCM / white-balance
inversion, RGGB mosaic, shot+read noise with log-log sampled levels,
then white balance, bilinear demosaic (with the flip trick for the green
planes), CCM and gamma compression.
"""

from __future__ import annotations

import numpy as np

from marconet_tpu_torch.utils.image import INTER_LINEAR, resize

_XYZ2CAMS = np.array([
    [[1.0234, -0.2969, -0.2266],
     [-0.5625, 1.6328, -0.0469],
     [-0.0703, 0.2188, 0.6406]],
    [[0.4913, -0.0541, -0.0202],
     [-0.613, 1.3513, 0.2906],
     [-0.1564, 0.2151, 0.7183]],
    [[0.838, -0.263, -0.0639],
     [-0.2887, 1.0725, 0.2496],
     [-0.0627, 0.1427, 0.5438]],
    [[0.6596, -0.2079, -0.0562],
     [-0.4782, 1.3016, 0.1933],
     [-0.097, 0.1581, 0.5181]]], np.float64)

_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]], np.float64)


def _random_ccm(rng):
    w = rng.uniform(1e-8, 1e8, (4, 1, 1))
    xyz2cam = (_XYZ2CAMS * w).sum(0) / w.sum()
    rgb2cam = xyz2cam @ _RGB2XYZ
    return rgb2cam / rgb2cam.sum(axis=-1, keepdims=True)


def _unprocess(rng, img):
    rgb2cam = _random_ccm(rng)
    cam2rgb = np.linalg.inv(rgb2cam)
    rgb_gain = 1.0 / rng.normal(0.8, 0.1)
    red_gain = rng.uniform(1.9, 2.4)
    blue_gain = rng.uniform(1.5, 1.9)

    # inverse tone mapping + gamma expansion
    x = np.clip(img, 0.0, 1.0)
    x = 0.5 - np.sin(np.arcsin(1.0 - 2.0 * x) / 3.0)
    x = np.clip(x, 1e-8, None) ** 2.2
    # inverse color correction
    x = x @ rgb2cam.T
    # safe inverse gains (mask saturated pixels)
    gains = np.array([1.0 / red_gain, 1.0, 1.0 / blue_gain]) / rgb_gain
    gray = x.mean(axis=-1, keepdims=True)
    mask = (np.clip(gray - 0.9, 0.0, None) / 0.1) ** 2.0
    safe = np.maximum(mask + (1.0 - mask) * gains, gains)
    x = np.clip(x * safe, 0.0, 1.0)

    # RGGB mosaic -> (H/2, W/2, 4)
    bayer = np.stack([x[0::2, 0::2, 0], x[0::2, 1::2, 1],
                      x[1::2, 0::2, 1], x[1::2, 1::2, 2]], axis=-1)
    return bayer, cam2rgb, red_gain, blue_gain


def _add_raw_noise(rng, bayer):
    log_shot = rng.uniform(np.log(0.0001), np.log(0.012))
    shot = np.exp(log_shot)
    read = np.exp(2.18 * log_shot + 1.20 + rng.normal(0.0, 0.26))
    var = bayer * shot + read
    return bayer + rng.standard_normal(bayer.shape) * np.sqrt(var)


def _up2x(plane):
    """x2 half-pixel bilinear upsample of a 2-D plane (in f32, as cv2)."""
    h, w = plane.shape
    return resize(plane.astype(np.float32), (2 * w, 2 * h),
                  INTER_LINEAR).astype(np.float64)


def _demosaic(bayer):
    red = _up2x(bayer[..., 0])
    blue = _up2x(bayer[..., 3])
    gr = _up2x(bayer[..., 1][:, ::-1])[:, ::-1]
    gb = _up2x(bayer[..., 2][::-1, :])[::-1, :]

    def planes(x):  # 2x2 phase planes of a full-res image
        return np.stack([x[0::2, 0::2], x[0::2, 1::2],
                         x[1::2, 0::2], x[1::2, 1::2]], -1)

    pr, pb = planes(gr), planes(gb)
    g = np.empty_like(red)
    g[0::2, 0::2] = (pr[..., 0] + pb[..., 0]) / 2.0
    g[0::2, 1::2] = pr[..., 1]
    g[1::2, 0::2] = pb[..., 2]
    g[1::2, 1::2] = (pr[..., 3] + pb[..., 3]) / 2.0
    return np.stack([red, g, blue], axis=-1)


def camera_isp_noise(rng: np.random.Generator,
                     img: np.ndarray) -> np.ndarray:
    """Round-trip an RGB [0,1] image through the simulated camera.

    Requires even H/W; odd trailing rows/cols pass through unchanged.
    """
    h, w = img.shape[:2]
    he, we = h - h % 2, w - w % 2
    if he < 2 or we < 2:
        return img
    core = img[:he, :we].astype(np.float64)

    bayer, cam2rgb, red_gain, blue_gain = _unprocess(rng, core)
    bayer = _add_raw_noise(rng, bayer)
    # process back
    gains = np.array([red_gain, 1.0, 1.0, blue_gain])
    bayer = np.clip(bayer * gains, 0.0, 1.0)
    rgb = _demosaic(bayer)
    rgb = rgb @ cam2rgb.T
    rgb = np.clip(rgb, 1e-8, 1.0) ** (1.0 / 2.2)

    out = img.astype(np.float32).copy()
    out[:he, :we] = np.clip(rgb, 0.0, 1.0).astype(np.float32)
    return out
