"""Helpers shared by the port's CLIs."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from marconet_tpu_torch.models.frontend import CharacterFrontend
from marconet_tpu_torch.utils.png import read_png

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def read_image(path: str) -> Optional[np.ndarray]:
    """An (H, W, 3) uint8 RGB image, or None after a warning that names
    the file when it is not a PNG the codec reads."""
    try:
        return read_png(path)
    except (ValueError, OSError) as e:
        print(f"WARNING: skipping {path}: {e} (input is PNG only)")
        return None


def load_frontend(ckpt_dir: str, device) -> Optional[CharacterFrontend]:
    """The detection front-end from ``ckpt_dir``, or None after a warning
    when its YOLO checkpoint is not there."""
    try:
        return CharacterFrontend.from_checkpoints(ckpt_dir, device=device)
    except FileNotFoundError as e:
        print(f"WARNING: detection front-end unavailable ({e}); "
              "falling back to filename labels")
        return None


def text_from_name(file_name: str) -> str:
    """Ground-truth text of ``<stem>_<text>.<ext>``: after the last ``_``
    (reference ``test_sr.py:155-162``)."""
    return os.path.splitext(file_name)[0].split("_")[-1]
