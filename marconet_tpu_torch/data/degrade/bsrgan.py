"""BSRGAN shuffle-order degradation pipeline (host-side numpy).

Behavioural port of the reference's tuned copy
(``Train/util/real_esrgan_bsrgan_degradation.py:946-1033``): blur x2,
two downsampling events (the second kept last), Gaussian noise, JPEG, and
camera-ISP simulation, applied in a random order; final JPEG with p=0.4.
Tuned values preserved: JPEG quality [30,85], gaussian noise level [3,25],
isp/jpeg/scale2 probabilities (0.25, 0.8, 0.25).

Input/output: (H, W, 3) RGB float32 in [0,1].

Counterpart of ``marconet_tpu/data/degrade/bsrgan.py`` with the same
random draws in the same order; its cv2 resizes are the port's own
``utils/image.resize``. The JAX package's ``_add_jpeg`` is a libjpeg round
trip (``cv2.imencode`` / ``cv2.imdecode``); here it is
``utils/jpeg.jpeg_roundtrip_u8``, which computes libjpeg-turbo's
coefficients and decodes them as libjpeg-turbo does: the same bytes
(``tests/test_torch_degrade.py::test_bsrgan_jpeg_deviation``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from marconet_tpu_torch.data.degrade import kernels as K
from marconet_tpu_torch.data.degrade.camera_isp import camera_isp_noise
from marconet_tpu_torch.data.imutils import (
    imresize_np,
    single2uint,
    uint2single,
)
from marconet_tpu_torch.utils.image import (
    INTER_AREA,
    INTER_CUBIC,
    INTER_LANCZOS4,
    INTER_LINEAR,
    resize,
)
from marconet_tpu_torch.utils.jpeg import jpeg_roundtrip_u8

# drawn by code, as the JAX package draws cv2's codes from the same lists
_CV2_M = [INTER_LINEAR, INTER_CUBIC, INTER_AREA]
_CV2_M4 = [INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4]


def _add_blur(rng, img, sf):
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    ksize = 2 * rng.integers(2, 8) + 3
    if rng.random() < 0.3:
        k = K.anisotropic_gaussian(ksize, rng.random() * np.pi,
                                   wd2 * rng.random(), wd2 * rng.random())
    else:
        k = K.fspecial_gaussian(ksize, wd * rng.random() + 1e-3)
    return ndimage.convolve(img, k[..., None].astype(np.float32),
                            mode="mirror")


def _add_gaussian_noise(rng, img, level1=3, level2=25):
    from scipy.linalg import orth

    level = rng.integers(level1, level2 + 1)
    r = rng.random()
    if r > 0.6:  # color
        img = img + rng.normal(0, level / 255.0,
                               img.shape).astype(np.float32)
    elif r < 0.4:  # gray
        img = img + rng.normal(0, level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:  # channel-correlated
        ll = level2 / 255.0
        d = np.diag(rng.random(3))
        u = orth(rng.random((3, 3)))
        conv = u.T @ d @ u
        img = img + rng.multivariate_normal(
            [0, 0, 0], np.abs(ll ** 2 * conv),
            img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _add_jpeg(rng, img, q_lo=30, q_hi=85):
    """libjpeg's JPEG round trip at a drawn quality on the uint8 grid."""
    q = int(rng.integers(q_lo, q_hi + 1))
    return uint2single(jpeg_roundtrip_u8(single2uint(img), q))


def bsrgan_degradation(img: np.ndarray, sf: int = 4,
                       lq_patchsize: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None,
                       use_isp: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Degrade an RGB [0,1] image; returns (lq, hq). ``lq_patchsize`` is
    accepted for API parity and ignored (the reference disables random
    cropping for text lines)."""
    rng = rng or np.random.default_rng()
    h1, w1 = img.shape[:2]
    img = img[:h1 - h1 % sf, :w1 - w1 % sf].astype(np.float32).copy()
    hq = img.copy()

    if sf == 4 and rng.random() < 0.25:
        if rng.random() < 0.5:
            img = resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                         int(rng.choice(_CV2_M4)))
        else:
            img = imresize_np(img, 0.5, True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = list(rng.permutation(7))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:  # keep the final downsample last
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]
    for step in order:
        if step in (0, 1):
            img = _add_blur(rng, img, sf)
        elif step == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                img = resize(img, (int(img.shape[1] / sf1),
                                   int(img.shape[0] / sf1)),
                             int(rng.choice(_CV2_M)))
            else:
                k = K.fspecial_gaussian(15, rng.uniform(0.1, 0.6 * sf))
                k = K.shift_pixel(k, sf)
                k = k / k.sum()
                img = ndimage.convolve(img, k[..., None].astype(np.float32),
                                       mode="mirror")
                img = img[0::sf, 0::sf]
            img = np.clip(img, 0.0, 1.0)
        elif step == 3:
            img = resize(img, (int(a / sf), int(b / sf)),
                         int(rng.choice(_CV2_M)))
            img = np.clip(img, 0.0, 1.0)
        elif step == 4:
            img = _add_gaussian_noise(rng, img, 3, 25)
        elif step == 5:
            if rng.random() < 0.8:
                img = _add_jpeg(rng, img)
        elif step == 6:
            if use_isp and rng.random() < 0.25:
                img = camera_isp_noise(rng, img)

    if rng.random() > 0.6:
        img = _add_jpeg(rng, img)

    return img.astype(np.float32), hq
