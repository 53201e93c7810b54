"""Real-ESRGAN two-stage degradation pipeline (host-side numpy).

Counterpart of ``marconet_tpu/data/degrade/realesrgan.py`` with the same
random draws in the same order; its cv2 calls are the port's own
``utils/image.resize`` and ``filter2d``, and its JPEG is ``jpeg_np`` (what
the JAX package's ``data/native.jpeg_roundtrip`` computes).

Behavioural port of the reference's tuned copy
(``Train/util/real_esrgan_bsrgan_degradation.py:1227-1469``) with its
modified parameter values (blur_kernel_size 13, final_sinc_prob 0.4, noise
ranges [1,20]/[1,15], jpeg range [50,95], second_blur_prob 0.3, etc.).

Pipeline: blur(k1) -> random resize -> gaussian|poisson noise -> JPEG ->
[blur(k2)?] -> resize toward 1/scale -> noise -> {JPEG, resize+sinc} in
random order -> round to uint8 grid.

Input/output: (H, W, 3) RGB float32 in [0,1]. (The reference takes BGR and
flips internally; this implementation is RGB end-to-end — the caller
handles channel order.)
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from marconet_tpu_torch.data.degrade import kernels as K
from marconet_tpu_torch.data.degrade.diffjpeg import jpeg_np
from marconet_tpu_torch.data.degrade.noise import gaussian_noise, poisson_noise
from marconet_tpu_torch.utils.image import (
    INTER_AREA,
    INTER_CUBIC,
    INTER_LINEAR,
    filter2d,
    resize,
)

_KERNEL_LIST = ["iso", "aniso", "generalized_iso", "generalized_aniso",
                "plateau_iso", "plateau_aniso"]
_KERNEL_PROB = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
_KERNEL_RANGE = [2 * v + 1 for v in range(3, 9)]  # 7..17

# drawn by code, as the JAX package draws cv2's codes from the same list
_CV2_MODES = [INTER_AREA, INTER_LINEAR, INTER_CUBIC]


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return filter2d(img, kernel.astype(np.float32))


def _rand_kernel(rng, sinc_prob: float, sigma_range, betag, betap):
    ksize = int(rng.choice(_KERNEL_RANGE))
    if rng.uniform() < sinc_prob:
        lo = np.pi / 3 if ksize < 13 else np.pi / 5
        return K.circular_lowpass_kernel(rng.uniform(lo, np.pi), ksize)
    return K.random_mixed_kernel(rng, _KERNEL_LIST, _KERNEL_PROB, ksize,
                                 sigma_range, sigma_range,
                                 (-math.pi, math.pi), betag, betap)


def _resize(img, scale=None, size=None, mode=None):
    if size is None:
        size = (int(img.shape[1] * scale), int(img.shape[0] * scale))
    return resize(img, size, int(mode))


def real_esrgan_degradation(img: np.ndarray, insf: int = 4,
                            rng: Optional[np.random.Generator] = None
                            ) -> np.ndarray:
    """Degrade an RGB [0,1] image; output is ~1/insf of the input size."""
    rng = rng or np.random.default_rng()
    ori_h, ori_w = img.shape[:2]
    out = img.astype(np.float32)

    kernel1 = _rand_kernel(rng, 0.1, (0.2, 3.0), (0.5, 4.0), (1.0, 2.0))
    kernel2 = _rand_kernel(rng, 0.1, (0.2, 1.5), (0.5, 4.0), (1.0, 2.0))
    if rng.uniform() < 0.4:
        ksize = int(rng.choice(_KERNEL_RANGE))
        sinc = K.circular_lowpass_kernel(
            rng.uniform(np.pi / 3, np.pi), ksize, pad_to=21)
    else:
        sinc = None  # pulse kernel == identity

    # ---- stage 1 ----------------------------------------------------------
    out = _filter2d(out, kernel1)
    updown = rng.choice(["up", "down", "keep"], p=[0.2, 0.7, 0.1])
    s = {"up": rng.uniform(1, 1.5), "down": rng.uniform(0.15, 1),
         "keep": 1.0}[updown]
    out = _resize(out, scale=s, mode=rng.choice(_CV2_MODES))
    if rng.uniform() < 0.3:
        out = gaussian_noise(rng, out, (1, 20), gray_prob=0.3)
    else:
        out = poisson_noise(rng, out, (0.05, 3), gray_prob=0.3)
    out = jpeg_np(np.clip(out, 0, 1), rng.uniform(50, 95))

    # ---- stage 2 ----------------------------------------------------------
    if rng.uniform() < 0.3:
        out = _filter2d(out, kernel2)
    updown = rng.choice(["up", "down", "keep"], p=[0.3, 0.4, 0.3])
    s = {"up": rng.uniform(1, 1.2), "down": rng.uniform(0.3, 1),
         "keep": 1.0}[updown]
    out = _resize(out, size=(int(ori_w / insf * s), int(ori_h / insf * s)),
                  mode=rng.choice(_CV2_MODES))
    if rng.uniform() < 0.3:
        out = gaussian_noise(rng, out, (1, 15), gray_prob=0.4)
    else:
        out = poisson_noise(rng, out, (0.05, 2.5), gray_prob=0.4)

    # ---- final: {resize+sinc, JPEG} in random order ----------------------
    final_size = (ori_w // insf, ori_h // insf)

    def resize_sinc(o):
        o = _resize(o, size=final_size, mode=rng.choice(_CV2_MODES))
        return _filter2d(o, sinc) if sinc is not None else o

    def jpeg(o):
        return jpeg_np(np.clip(o, 0, 1), rng.uniform(50, 95))

    if rng.uniform() < 0.5:
        out = jpeg(resize_sinc(out))
    else:
        out = resize_sinc(jpeg(out))

    return np.clip(np.round(np.clip(out, 0, 1) * 255.0), 0,
                   255).astype(np.float32) / 255.0
