"""Sequence-based paired degradation (counterpart of ``marconet_tpu/data/
degrade/paired.py``).

The reference's ``Train/util/same_degradation.py:38-333`` (dead code
there, never imported by the dataset): sample a degradation *sequence*
once, then apply the identical sequence to two images so that a paired
supervision signal survives the degradation. Steps: blur, resize, gaussian
noise, JPEG and camera ISP, each recorded with its sampled parameters; the
same draws from the same seed as the JAX package's.

Without cv2: the resize modes are OpenCV's codes for
``utils/image.resize`` (``INTER_LINEAR`` / ``INTER_CUBIC`` / ``INTER_AREA``,
cv2's float results); the blur stays ``scipy.ndimage``. The JAX module's
JPEG step is a libjpeg round trip through cv2; here it is
``utils/jpeg.jpeg_roundtrip_u8`` on the uint8 grid, byte for byte the same,
as BSRGAN's ``_add_jpeg`` of the port (``data/degrade/bsrgan.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
from scipy import ndimage

from marconet_tpu_torch.data.degrade import kernels as K
from marconet_tpu_torch.data.degrade.camera_isp import camera_isp_noise
from marconet_tpu_torch.data.imutils import single2uint, uint2single
from marconet_tpu_torch.utils.image import (
    INTER_AREA,
    INTER_CUBIC,
    INTER_LINEAR,
    resize,
)
from marconet_tpu_torch.utils.jpeg import jpeg_roundtrip_u8

_MODES = [INTER_LINEAR, INTER_CUBIC, INTER_AREA]


def get_degrade_seq(rng: np.random.Generator, sf: int = 4
                    ) -> List[Dict[str, Any]]:
    """Sample a reusable degradation sequence."""
    seq: List[Dict[str, Any]] = []
    # blur
    if rng.random() < 0.7:
        ksize = int(2 * rng.integers(2, 8) + 3)
        if rng.random() < 0.3:
            kernel = K.anisotropic_gaussian(
                ksize, rng.random() * np.pi,
                (4.0 + sf) * rng.random(), (4.0 + sf) * rng.random())
        else:
            kernel = K.fspecial_gaussian(ksize,
                                         (2.0 + 0.2 * sf) * rng.random()
                                         + 1e-3)
        seq.append({"type": "blur", "kernel": kernel})
    # downsample
    seq.append({
        "type": "resize",
        "scale": 1.0 / rng.uniform(1.0, 2.0 * sf),
        "mode": int(rng.choice(_MODES)),
    })
    # noise
    if rng.random() < 0.6:
        seq.append({"type": "noise",
                    "sigma": int(rng.integers(2, 26))})
    # jpeg
    if rng.random() < 0.7:
        seq.append({"type": "jpeg",
                    "quality": int(rng.integers(30, 96))})
    # camera isp
    if rng.random() < 0.2:
        seq.append({"type": "camera", "seed": int(rng.integers(0, 2 ** 31))})
    return seq


def jpeg_u8(img: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's JPEG round trip of an RGB [0, 1] image at ``quality``, on
    the uint8 grid in and out."""
    return uint2single(jpeg_roundtrip_u8(single2uint(img), quality))


def apply_degrade_seq(img: np.ndarray,
                      seq: List[Dict[str, Any]]) -> np.ndarray:
    """Apply a sampled sequence to an RGB [0, 1] image deterministically."""
    out = img.astype(np.float32)
    for step in seq:
        t = step["type"]
        if t == "blur":
            out = ndimage.convolve(
                out, step["kernel"][..., None].astype(np.float32),
                mode="mirror")
        elif t == "resize":
            s = step["scale"]
            out = resize(out, (max(int(out.shape[1] * s), 1),
                               max(int(out.shape[0] * s), 1)), step["mode"])
        elif t == "noise":
            rng = np.random.default_rng(step.get("seed", 0))
            out = out + rng.normal(0, step["sigma"] / 255.0,
                                   out.shape).astype(np.float32)
        elif t == "jpeg":
            out = jpeg_u8(np.clip(out, 0, 1), step["quality"])
        elif t == "camera":
            out = camera_isp_noise(np.random.default_rng(step["seed"]),
                                   np.clip(out, 0, 1))
        out = np.clip(out, 0.0, 1.0)
    return out


def degrade_pair(rng: np.random.Generator, img_a: np.ndarray,
                 img_b: np.ndarray, sf: int = 4
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Degrade two images with one identical sampled sequence."""
    seq = get_degrade_seq(rng, sf)
    for step in seq:
        if step["type"] == "noise":
            step["seed"] = int(rng.integers(0, 2 ** 31))
    return apply_degrade_seq(img_a, seq), apply_degrade_seq(img_b, seq)
