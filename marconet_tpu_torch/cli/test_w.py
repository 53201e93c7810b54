"""Font-style interpolation CLI (counterpart of ``tools/test_w.py``).

Extracts the style vectors of two LQ lines, blends them in 11 steps and
renders the first line's characters (its encoder's CTC labels) in each
blend: one PNG per blend, ``w_0.00.png`` ... ``w_1.00.png``, and the 11
as an animated ``w.gif`` (``utils/gif.py``; 10 hundredths of a second a
frame, looping, the 0.1 s a frame that the JAX tool asks imageio for).
The 11 blends run as one prior batch.

Example::

    python -m marconet_tpu_torch.cli.test_w -w1 w1.png -w2 w2.png \\
        -o out/ --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np
import torch

from marconet_tpu_torch.alphabet import collapse_ctc_labels
from marconet_tpu_torch.cli.common import read_image
from marconet_tpu_torch.convert import load_reference_or_random
from marconet_tpu_torch.models.pipeline import MARCONet
from marconet_tpu_torch.utils.image import preprocess_line
from marconet_tpu_torch.utils.gif import write_gif
from marconet_tpu_torch.utils.png import write_png

STEPS = 11
GIF_DELAY_CS = 10         # the JAX tool's duration=0.1 (seconds a frame)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-w1", "--w1_path", type=str,
                   default="./Testsets/TestW/w1.png")
    p.add_argument("-w2", "--w2_path", type=str,
                   default="./Testsets/TestW/w2.png")
    p.add_argument("-o", "--save_path", type=str,
                   default="./Testsets/TestW")
    p.add_argument("--ckpt_dir", type=str, default="./checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the networks run (cuda or cpu)")
    return p


def load_lq(path: str) -> np.ndarray:
    """(1, 32, 512, 3) model input of a line image; exits when it cannot
    be read or is too wide."""
    img = read_image(path)
    if img is None:
        sys.exit(f"{path}: cannot read the image")
    pre = preprocess_line(img)
    if pre is None:
        sys.exit(f"{path}: width exceeds 512 after resize to h=32")
    return pre[0]


def interpolate(net: MARCONet, lq1: np.ndarray, lq2: np.ndarray,
                save_path: str) -> List[str]:
    """Write the 11 blends of the two lines' styles as PNGs and
    ``w.gif``; returns the PNGs' paths."""
    logits1, _, w1 = net.encode(torch.from_numpy(lq1))
    _, _, w2 = net.encode(torch.from_numpy(lq2))
    labels = collapse_ctc_labels(logits1[0].float().cpu().numpy())
    if not labels:
        sys.exit("no characters recognized in w1 image")
    print(f"Interpolating over {len(labels)} characters")
    weights = torch.linspace(0.0, 1.0, STEPS)
    imgs = net.interpolate_styles(w1[0], w2[0], torch.tensor(labels),
                                  weights).float().cpu().numpy()
    paths, frames = [], []
    for i in range(imgs.shape[0]):
        row = np.clip(np.concatenate(list(imgs[i]), axis=1) * 0.5 + 0.5,
                      0, 1)
        frames.append((row * 255).astype(np.uint8))
        scale = i / (STEPS - 1)
        print(f"Interpolating w1 and w2 with weight {scale:.2f}")
        paths.append(os.path.join(save_path, f"w_{scale:.2f}.png"))
        write_png(paths[-1], frames[-1])
    write_gif(os.path.join(save_path, "w.gif"), frames, GIF_DELAY_CS)
    print("Finishing interpolation.")
    return paths


def main(argv=None) -> List[str]:
    args = parser().parse_args(argv)
    os.makedirs(args.save_path, exist_ok=True)
    net = MARCONet(device=args.device)
    load_reference_or_random(net, args.ckpt_dir)
    return interpolate(net, load_lq(args.w1_path), load_lq(args.w2_path),
                       args.save_path)


if __name__ == "__main__":
    main()
