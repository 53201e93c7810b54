"""Dump synthetic training samples for visual inspection (counterpart of
``tools/syndata_demo.py``, the reference's ``Train/syndata_demo.py:459-514``
/ ``Train/README.md:58-68``).

Writes ``<i>_gt.png``, ``<i>_mask.png``, ``<i>_lq.png`` and
``<i>_locs.png`` (the GT line with each character's left column marked
red and its right one blue) for ``--num`` samples of the port's
synthesizer, with the JAX tool's flags and defaults::

    python -m marconet_tpu_torch.cli.syndata_demo -o samples/ -n 4 \
        --font_dir tests/data/fonts
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from marconet_tpu_torch.data.synth import GT_W, SynthConfig, \
    TextLineSynthesizer
from marconet_tpu_torch.utils.png import write_png


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--out_dir", default="./syn_data_samples")
    parser.add_argument("-n", "--num", type=int, default=4)
    parser.add_argument("--font_dir", default="./TrainData/FontsType-V1")
    parser.add_argument("--bg_dir", default="./TrainData/BGSample")
    parser.add_argument("--corpus", default="")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def save(path: str, img01: np.ndarray) -> None:
    """A [0, 1] RGB image as an 8-bit PNG (truncated, as the JAX tool's
    ``astype(np.uint8)``)."""
    write_png(path, (np.clip(img01, 0, 1) * 255).astype(np.uint8))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = SynthConfig(font_dir=args.font_dir, bg_dir=args.bg_dir,
                      corpus_paths=(args.corpus,) if args.corpus else ())
    synth = TextLineSynthesizer(cfg)
    rng = np.random.default_rng(args.seed)

    for i in range(args.num):
        s = synth.sample(rng)

        def out(name: str) -> str:
            return os.path.join(args.out_dir, f"{i:03d}_{name}.png")

        save(out("gt"), s["gt"] * 0.5 + 0.5)
        save(out("mask"), s["mask"])
        save(out("lq"), s["lq"] * 0.5 + 0.5)

        locs_img = (s["gt"] * 0.5 + 0.5).copy()
        for c in range(len(s["text"])):
            l_px = int(s["boxinfo"][2 * c] * GT_W)
            r_px = int(s["boxinfo"][2 * c + 1] * GT_W)
            locs_img[:, max(l_px - 1, 0):l_px + 1] = [1, 0, 0]
            locs_img[:, max(r_px - 1, 0):r_px + 1] = [0, 0, 1]
        save(out("locs"), locs_img)
        print(f"sample {i}: text={s['text']!r}")
    print(f"wrote {args.num} samples to {args.out_dir}")


if __name__ == "__main__":
    main()
