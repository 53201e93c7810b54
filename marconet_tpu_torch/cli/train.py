"""Training CLI (counterpart of ``tools/train.py``).

    python -m marconet_tpu_torch.cli.train -opt options/train.yml \
        [--max_steps N] [--allow_random_lpips] [--device cpu]

Reads the YAML config (``train/config.py``) and runs the loop
(``train/loop.py``) on one device, CUDA unless ``--device`` names another.
The default synthesizer needs a glyph renderer and the font pack, which
the repository does not have (``data/synth.py``): until then training
stops at the first batch with that message.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from marconet_tpu_torch.train.config import load_config
from marconet_tpu_torch.train.loop import train


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", "--options", type=str,
                        default="options/train.yml")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop early (smoke tests)")
    parser.add_argument("--allow_random_lpips", action="store_true",
                        help="permit training without pretrained LPIPS "
                             "VGG weights (different objective!)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda)")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    config = load_config(args.options)
    if args.allow_random_lpips:
        config.loop.allow_random_lpips = True
    return train(config, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
