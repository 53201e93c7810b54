"""Random blur-kernel generators for the degradation pipelines
(counterpart of ``marconet_tpu/data/degrade/kernels.py``, the same numpy
and scipy code and the same random draws).

Standard Real-ESRGAN/BSRGAN kernel families (reference
``Train/util/real_esrgan_bsrgan_degradation.py:155-453,537-651,702-847``),
implemented from the underlying math: bivariate (an)isotropic Gaussian,
generalized Gaussian, plateau, circular sinc low-pass, MATLAB-``fspecial``
Gaussian, and the BSRGAN eigenvalue-parameterized anisotropic Gaussian.
All pure numpy, intended for host-side data workers.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from scipy import special


def _mesh(kernel_size: int) -> np.ndarray:
    """(k, k, 2) grid of (x, y) offsets centered on the kernel."""
    ax = np.arange(kernel_size) - kernel_size // 2
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], -1).astype(np.float64)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0.0], [0.0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quad_form(grid: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma)
    return np.einsum("...i,ij,...j->...", grid, inv, grid)


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float = None,
                       theta: float = 0.0, grid=None,
                       isotropic: bool = True) -> np.ndarray:
    if grid is None:
        grid = _mesh(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    k = np.exp(-0.5 * _quad_form(grid, _sigma_matrix(sig_x, sig_y, theta)))
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size: int, sig_x: float,
                                   sig_y: float, theta: float, beta: float,
                                   isotropic: bool = True) -> np.ndarray:
    grid = _mesh(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    q = _quad_form(grid, _sigma_matrix(sig_x, sig_y, theta))
    k = np.exp(-0.5 * np.power(q, beta))
    return k / k.sum()


def bivariate_plateau(kernel_size: int, sig_x: float, sig_y: float,
                      theta: float, beta: float,
                      isotropic: bool = True) -> np.ndarray:
    grid = _mesh(kernel_size)
    if isotropic:
        sig_y, theta = sig_x, 0.0
    q = _quad_form(grid, _sigma_matrix(sig_x, sig_y, theta))
    k = 1.0 / (np.power(q, beta) + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2-D sinc (airy-like) low-pass filter; ``kernel_size`` must be odd."""
    assert kernel_size % 2 == 1
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx ** 2 + yy ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = cutoff * special.j1(cutoff * r) / (2.0 * np.pi * r)
    k[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
        cutoff ** 2 / (4.0 * np.pi)
    k = k / k.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        k = np.pad(k, ((pad, pad), (pad, pad)))
    return k


def random_mixed_kernel(
        rng: np.random.Generator,
        kernel_list: Sequence[str],
        kernel_prob: Sequence[float],
        kernel_size: int,
        sigma_x_range: Tuple[float, float],
        sigma_y_range: Tuple[float, float],
        rotation_range: Tuple[float, float] = (-math.pi, math.pi),
        betag_range: Tuple[float, float] = (0.5, 4.0),
        betap_range: Tuple[float, float] = (1.0, 2.0)) -> np.ndarray:
    """Sample one kernel from the mixed family (basicsr semantics:
    generalized/plateau betas are drawn below or above 1 with equal
    probability)."""
    ktype = rng.choice(kernel_list, p=np.asarray(kernel_prob) /
                       np.sum(kernel_prob))
    sig_x = rng.uniform(*sigma_x_range)
    sig_y = rng.uniform(*sigma_y_range)
    theta = rng.uniform(*rotation_range)

    def beta(lo_hi):
        lo, hi = lo_hi
        if rng.random() < 0.5:
            return rng.uniform(lo, 1.0)
        return rng.uniform(1.0, hi)

    if ktype == "iso":
        return bivariate_gaussian(kernel_size, sig_x, isotropic=True)
    if ktype == "aniso":
        return bivariate_gaussian(kernel_size, sig_x, sig_y, theta,
                                  isotropic=False)
    if ktype == "generalized_iso":
        return bivariate_generalized_gaussian(
            kernel_size, sig_x, sig_x, 0.0, beta(betag_range),
            isotropic=True)
    if ktype == "generalized_aniso":
        return bivariate_generalized_gaussian(
            kernel_size, sig_x, sig_y, theta, beta(betag_range),
            isotropic=False)
    if ktype == "plateau_iso":
        return bivariate_plateau(kernel_size, sig_x, sig_x, 0.0,
                                 beta(betap_range), isotropic=True)
    if ktype == "plateau_aniso":
        return bivariate_plateau(kernel_size, sig_x, sig_y, theta,
                                 beta(betap_range), isotropic=False)
    raise ValueError(ktype)


def fspecial_gaussian(size: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') (reference ``:702-714``)."""
    ax = np.arange(size) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    k[k < np.finfo(float).eps * k.max()] = 0
    return k / k.sum()


def anisotropic_gaussian(ksize: int, theta: float, l1: float,
                         l2: float) -> np.ndarray:
    """BSRGAN's eigenvalue-parameterized anisotropic Gaussian
    (reference ``add_blur``, ``:849-860``)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    v2 = np.array([-v[1], v[0]])
    d = np.diag([max(l1, 1e-6), max(l2, 1e-6)])
    u = np.stack([v, v2], axis=1)
    sigma = u @ d @ u.T
    grid = _mesh(ksize)
    k = np.exp(-0.5 * _quad_form(grid, sigma))
    return k / k.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True):
    """Shift an array by 0.5*(sf-1) px via bilinear interpolation
    (reference ``:110-137``); used to align nearest-downsampling blurs."""
    from scipy.interpolate import RegularGridInterpolator

    h, w = x.shape[:2]
    shift = 0.5 * (sf - 1)
    xv = np.arange(1, w + 1.0)
    yv = np.arange(1, h + 1.0)
    if upper_left:
        x1 = np.clip(xv + shift, 1, w)
        y1 = np.clip(yv + shift, 1, h)
    else:
        x1 = np.clip(xv - shift, 1, w)
        y1 = np.clip(yv - shift, 1, h)
    pts = np.stack(np.meshgrid(y1, x1, indexing="ij"), -1)
    if x.ndim == 2:
        interp = RegularGridInterpolator((yv, xv), x, method="linear")
        return interp(pts)
    out = np.zeros_like(x)
    for c in range(x.shape[2]):
        interp = RegularGridInterpolator((yv, xv), x[..., c],
                                         method="linear")
        out[..., c] = interp(pts)
    return out
