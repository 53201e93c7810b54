"""Noise injection for the degradation pipelines (numpy, per-image;
counterpart of ``marconet_tpu/data/degrade/noise.py``, the same draws).

Semantics follow the reference's torch batch versions
(``real_esrgan_bsrgan_degradation.py:455-700``): random-sigma Gaussian
noise with a gray(-correlated) probability, and Poisson noise whose rate is
derived from the number of unique intensity levels (rounded up to the next
power of two), optionally scaled.
"""

from __future__ import annotations

import numpy as np

_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return img @ _GRAY_W


def gaussian_noise(rng: np.random.Generator, img: np.ndarray,
                   sigma_range=(0, 10), gray_prob: float = 0.0,
                   clip: bool = True) -> np.ndarray:
    """img: (H, W, 3) in [0,1]."""
    sigma = rng.uniform(*sigma_range)
    if rng.random() < gray_prob:
        noise = rng.standard_normal(img.shape[:2])[..., None] * sigma / 255.0
    else:
        noise = rng.standard_normal(img.shape) * sigma / 255.0
    out = img + noise.astype(np.float32)
    return np.clip(out, 0, 1) if clip else out


def _poisson_noise(rng: np.random.Generator, plane: np.ndarray) -> np.ndarray:
    """Unique-level-derived Poisson noise on a [0,1] plane."""
    q = np.clip(np.round(plane * 255.0), 0, 255) / 255.0
    vals = len(np.unique(q))
    vals = 2.0 ** np.ceil(np.log2(max(vals, 2)))
    return (rng.poisson(q * vals) / vals - q).astype(np.float32)


def poisson_noise(rng: np.random.Generator, img: np.ndarray,
                  scale_range=(0.0, 1.0), gray_prob: float = 0.0,
                  clip: bool = True) -> np.ndarray:
    scale = rng.uniform(*scale_range)
    if rng.random() < gray_prob:
        noise = _poisson_noise(rng, _rgb_to_gray(img))[..., None]
        noise = np.repeat(noise, 3, axis=2)
    else:
        noise = _poisson_noise(rng, img)
    out = img + noise * scale
    return np.clip(out, 0, 1) if clip else out
