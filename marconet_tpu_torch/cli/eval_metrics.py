"""PSNR / SSIM between two directories of images (counterpart of
``tools/eval_metrics.py``).

    python -m marconet_tpu_torch.cli.eval_metrics -a SR_DIR -b GT_DIR \
        [--border N] [--y_channel]

For every file name the two directories share: the image pair, read as
``cv2.imread`` reads it (``cli/common.read_image``: PNG, JPEG, BMP; a file
that cannot be read is named in a warning and skipped), the second image
resized to the first's size by OpenCV's uint8 ``INTER_CUBIC``
(``utils/image.resize_cubic_u8``) when they differ, then PSNR and SSIM
(``utils/image.calculate_psnr`` / ``calculate_ssim``, the reference's
``Train/util/utils_image.py:622,643``), on the Y channel of
``data/imutils.rgb2ycbcr`` with ``--y_channel``. Prints a line an image
and the means, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from marconet_tpu_torch.cli.common import read_image
from marconet_tpu_torch.data.imutils import rgb2ycbcr
from marconet_tpu_torch.utils.image import (
    calculate_psnr,
    calculate_ssim,
    resize_cubic_u8,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-a", "--dir_a", required=True,
                        help="restored/SR image dir")
    parser.add_argument("-b", "--dir_b", required=True,
                        help="reference/GT image dir")
    parser.add_argument("--border", type=int, default=0)
    parser.add_argument("--y_channel", action="store_true")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    names = sorted(set(os.listdir(args.dir_a)) &
                   set(os.listdir(args.dir_b)))
    if not names:
        sys.exit("no common files between the two directories")

    psnrs, ssims = [], []
    for name in names:
        a = read_image(os.path.join(args.dir_a, name))
        b = read_image(os.path.join(args.dir_b, name))
        if a is None or b is None:
            continue
        if a.shape != b.shape:
            b = resize_cubic_u8(b, size=(a.shape[1], a.shape[0]))
        if args.y_channel:
            a = rgb2ycbcr(a / 255.0, only_y=True) * 255.0
            b = rgb2ycbcr(b / 255.0, only_y=True) * 255.0
        p = calculate_psnr(a, b, border=args.border)
        s = calculate_ssim(a.astype(np.float64), b.astype(np.float64),
                           border=args.border)
        psnrs.append(p)
        ssims.append(s)
        print(f"{name}: PSNR {p:.3f} dB  SSIM {s:.4f}")

    print(f"\nmean over {len(psnrs)} images: "
          f"PSNR {np.mean(psnrs):.3f} dB  SSIM {np.mean(ssims):.4f}")
    return psnrs, ssims


if __name__ == "__main__":
    main()
