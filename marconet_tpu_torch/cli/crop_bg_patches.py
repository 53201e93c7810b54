"""Mine background patches from DF2K-style HR images (counterpart of
``tools/crop_bg_patches.py``, the reference's
``Train/scripts/crop_DF2K.py:31-104``).

Each image is taken at scales 1, 0.75 and 0.5 (OpenCV's uint8
``INTER_AREA``, ``utils/image.resize_area_u8``); at each scale
``4 * per_scale`` random ``patch`` x ``patch`` crops are drawn and the
``per_scale`` with the highest variance of the Sobel gradient magnitude
kept (texture-rich backgrounds degrade more realistically). The same
seed gives the same patches, byte for byte and in the same order, as the
JAX package's tool. Patches are written as ``patch_<n>.png``::

    python -m marconet_tpu_torch.cli.crop_bg_patches -i DF2K_HR -o bg/
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from marconet_tpu_torch.utils.image import filter2d, resize_area_u8
from marconet_tpu_torch.utils.imread import imread
from marconet_tpu_torch.utils.png import write_png

SCALES = (1.0, 0.75, 0.5)
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2's uint8 ``COLOR_RGB2GRAY`` (its ``COLOR_BGR2GRAY`` of the same
    pixels) in OpenCV 5's 15-bit fixed point, whose weights sum to
    32768: ``(R * 9798 + G * 19235 + B * 3735 + 16384) >> 15``. (OpenCV
    4's 14-bit weights 4899 / 9617 / 1868 miss it by one level on about
    0.2% of random pixels.)"""
    p = rgb.astype(np.int32)
    return ((p[..., 0] * 9798 + p[..., 1] * 19235 + p[..., 2] * 3735
             + 16384) >> 15).astype(np.uint8)


def sobel_score(gray: np.ndarray) -> float:
    """Variance of the gradient magnitude of ``cv2.Sobel(gray, CV_32F,
    1, 0)`` and ``(.., 0, 1)`` (3 x 3, ``BORDER_REFLECT_101``), in f32."""
    g = gray.astype(np.float32)
    gx = filter2d(g, SOBEL_X)
    gy = filter2d(g, SOBEL_X.T.copy())
    return float(np.var(np.hypot(gx, gy)))


def mine_patches(img: np.ndarray, patch: int, per_scale: int,
                 rng: np.random.Generator) -> List[np.ndarray]:
    """The kept (patch, patch, 3) uint8 crops of one (H, W, 3) image, in
    the JAX tool's order and from the same draws of ``rng``."""
    out = []
    for scale in SCALES:
        im = resize_area_u8(img, scale)
        h, w = im.shape[:2]
        if h < patch or w < patch:
            continue
        cands = []
        for _ in range(per_scale * 4):
            y = int(rng.integers(0, h - patch + 1))
            x = int(rng.integers(0, w - patch + 1))
            crop = im[y:y + patch, x:x + patch]
            cands.append((sobel_score(gray_u8(crop)), crop))
        cands.sort(key=lambda t: -t[0])
        out.extend(c for _, c in cands[:per_scale])
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--patch", type=int, default=400)
    p.add_argument("--per_scale", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> List[str]:
    args = parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    paths = []
    for name in sorted(os.listdir(args.input_dir)):
        img = imread(os.path.join(args.input_dir, name))
        if img is None:
            continue
        for crop in mine_patches(img, args.patch, args.per_scale, rng):
            paths.append(os.path.join(args.output_dir,
                                      f"patch_{len(paths):06d}.png"))
            write_png(paths[-1], np.ascontiguousarray(crop))
    print(f"wrote {len(paths)} patches to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
