"""Host-side training-batch preparation, without cv2 (counterpart of
``marconet_tpu/data/batch_prep.py``).

The reference computes char-crop geometry and ground-truth glyph canvases
inside its training loop with python loops (``tspgan_model.py:425-439,
509-549``). All of it depends only on the dataset's outputs (``boxinfo``,
``mask``, ``label``), so it is computed here on the host with numpy: each
sample gets fixed-shape crop indices / weights and glyph canvases, and the
device step has static shapes. The card's machine has no cv2, so the one
``cv2.resize(..., INTER_LINEAR)`` of the JAX package is the port's numpy
``utils/image.resize`` (:func:`resize_width_linear`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from marconet_tpu_torch.alphabet import BLANK_INDEX
from marconet_tpu_torch.utils.image import INTER_LINEAR, resize

GT_HEIGHT = 128
CHAR_SIZE = 128


def _crop_taps(center: int, half: int = 64, width: int = 2048):
    """2-tap x-resample implementing crop(center +- half) + resize-to-128.

    Returns (idx0 (128,), w0 (128,)). Interior crops are exact copies;
    truncated edge crops get half-pixel bilinear resampling (the
    reference's ``F.interpolate`` of the short crop).
    """
    x1 = 0 if center < half else center - half
    x2 = width if center + half > width else center + half
    lw = x2 - x1
    j = np.arange(2 * half)
    if lw == 2 * half:
        return (x1 + j).astype(np.int32), np.ones(2 * half, np.float32)
    s = (j + 0.5) * lw / (2.0 * half) - 0.5
    s = np.clip(s, 0.0, lw - 1.0)
    i0 = np.floor(s)
    w0 = 1.0 - (s - i0)
    return (x1 + i0).astype(np.int32), w0.astype(np.float32)


def resize_width_linear(img: np.ndarray, out_w: int) -> np.ndarray:
    """Resize an (H, W, C) f32 image to (H, out_w, C) as OpenCV's
    ``cv2.resize(img, (out_w, H), interpolation=cv2.INTER_LINEAR)`` does
    (:func:`marconet_tpu_torch.utils.image.resize`)."""
    return resize(img, (out_w, img.shape[0]), INTER_LINEAR)


def glyph_canvas(ink_mask: np.ndarray, l_px: int, r_px: int) -> np.ndarray:
    """Centered [-1, 1] glyph canvas from the ink mask (reference
    ``tspgan_model.py:425-439``).

    ink_mask: (128, W, 3) in {0, 1}. Returns (128, 128, 3) in [-1, 1].
    """
    canvas = np.full((CHAR_SIZE, CHAR_SIZE, 3), -1.0, np.float32)
    if r_px <= l_px:
        return canvas
    crop = ink_mask[:, l_px:r_px].astype(np.float32) * 2.0 - 1.0
    w = crop.shape[1]
    if w > CHAR_SIZE:
        return resize_width_linear(crop, CHAR_SIZE)
    off = 64 - w // 2
    canvas[:, off:off + w] = crop
    return canvas


def prepare_train_batch(gt: np.ndarray, ink_mask: np.ndarray,
                        labels: np.ndarray, boxinfo_lr: np.ndarray,
                        lq: np.ndarray) -> Dict[str, np.ndarray]:
    """Assemble the full fixed-shape training batch (numpy, NHWC).

    Args:
      gt: (B, 128, W, 3) in [-1, 1], W = 128 * slots.
      ink_mask: (B, 128, W, 3) in {0, 1}.
      labels: (B, slots) int, blank-padded.
      boxinfo_lr: (B, 2 * slots) normalized (left, right) pairs.
      lq: (B, 32, W / 4, 3) in [-1, 1].
    Returns the fields of :class:`marconet_tpu_torch.train.train_step.
    TrainBatch` as numpy arrays.
    """
    b = gt.shape[0]
    n_chars = labels.shape[1]
    gt_w = gt.shape[2]
    char_valid = np.zeros((b, n_chars), np.float32)
    box_valid = np.zeros((b, n_chars), np.float32)
    gt_chars = np.full((b, n_chars, CHAR_SIZE, CHAR_SIZE, 3), -1.0,
                       np.float32)
    crop_idx = np.zeros((b, n_chars, CHAR_SIZE), np.int32)
    crop_w0 = np.ones((b, n_chars, CHAR_SIZE), np.float32)
    patch_valid = np.zeros((b, n_chars), np.float32)

    for i in range(b):
        max_right = 0
        for c in range(n_chars):
            left = boxinfo_lr[i, 2 * c]
            right = boxinfo_lr[i, 2 * c + 1]
            has_box = (right - left) > 0.0
            if has_box:
                box_valid[i, c] = 1.0
                max_right = max(max_right, int(right * gt_w))
            if not has_box or labels[i, c] == BLANK_INDEX:
                continue
            char_valid[i, c] = 1.0
            l_px, r_px = int(left * gt_w), int(right * gt_w)
            gt_chars[i, c] = glyph_canvas(ink_mask[i], l_px, r_px)
            center = int((l_px + r_px) / 2)
            crop_idx[i, c], crop_w0[i, c] = _crop_taps(center, width=gt_w)
        n_patches = min(max_right // 128 + 1, n_chars)
        patch_valid[i, :n_patches] = 1.0

    return {
        "lq": lq.astype(np.float32),
        "gt": gt.astype(np.float32),
        "labels": labels.astype(np.int32),
        "boxinfo_lr": boxinfo_lr.astype(np.float32),
        "char_valid": char_valid,
        "box_valid": box_valid,
        "gt_chars": gt_chars,
        "crop_idx": crop_idx,
        "crop_w0": crop_w0,
        "patch_valid": patch_valid,
    }
