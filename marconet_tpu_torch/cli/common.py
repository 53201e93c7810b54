"""Helpers shared by the port's CLIs."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from marconet_tpu_torch.models.frontend import CharacterFrontend
from marconet_tpu_torch.utils.imread import imread

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the file names the JAX tools take as images (tools/serve_demo.py:65,
# tools/parity_report.py:54)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def read_image(path: str) -> Optional[np.ndarray]:
    """An (H, W, 3) uint8 RGB image read as ``cv2.imread`` reads it
    (``utils/imread.py``: PNG, JPEG, BMP), or None after a warning that
    names the file when cv2 would give None or the port reads no such
    file."""
    try:
        img = imread(path)
    except ValueError as e:
        print(f"WARNING: skipping {path}: {e}")
        return None
    if img is None:
        print(f"WARNING: skipping {path}: not a readable image")
    return img


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
