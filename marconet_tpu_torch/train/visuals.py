"""Training-time visual validation grids (counterpart of
``marconet_tpu/train/visuals.py``).

The reference's TensorBoard visuals (``Train/tspgan/models/
tspgan_model.py:244-314`` + ``nondist_validation`` ``:615-621``): every
``val_freq`` iterations the loop logs image grids of GT / SR / LQ, the
predicted-locs overlay and the GT-vs-generated glyph priors, and the
predicted text. The device forward is ``MARCONetTrainer.visual_forward``;
grid assembly is host-side numpy, the JAX package's ``cv2.resize`` being
``utils/image.resize``.

The predicted text is drawn as the JAX package draws it
(``render_text_row``), with the port's TrueType renderer
(``utils/text_draw.py``). **Deviation:** without a font (no ``font_dir``)
the JAX package draws it in Pillow's built-in bitmap font
(``ImageFont.load_default``), which the port does not have; there the
grids leave the panel out and the loop logs the text itself as the text
entry ``val/1_pred_text``.

All panel builders take float arrays in [-1, 1] (NHWC) and return HWC
uint8 grids ready for ``EventWriter.add_image``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.utils.image import INTER_LINEAR, resize
from marconet_tpu_torch.utils.text_draw import draw_text, truetype


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float HWC -> uint8."""
    return np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)


def ctc_collapse_ids(ids: np.ndarray) -> str:
    """Greedy CTC collapse of per-token argmax ids into text.

    Mirrors the reference's TB text decode (``tspgan_model.py:255-264``):
    drop consecutive repeats, skip ids beyond the alphabet (the blank
    class 6735 == len(alphabet) is thereby skipped).
    """
    chars = alphabet()
    out = []
    prev = -1
    for i in ids:
        i = int(i)
        if i != prev and i < len(chars):
            out.append(chars[i])
        prev = i
    return "".join(out)


def render_text_row(text: str, font_path: str, width: int = 512,
                    height: int = 32) -> np.ndarray:
    """Render predicted text green-on-black at 32 px (reference
    ``:266-275``, the JAX package's ``render_text_row`` with a font)."""
    img = np.zeros((height, width, 3), np.uint8)
    draw_text(img, (10, 0), text, truetype(font_path, 32), (0, 255, 0))
    return img


def draw_locs_overlay(img: np.ndarray, locs_cw_px: np.ndarray,
                      left_color=(255, 0, 0), right_color=(0, 0, 255),
                      pad: int = 2) -> np.ndarray:
    """Vertical box-edge marks on a [-1,1] HWC image.

    ``locs_cw_px``: flat (2N,) of (center, half-width) in pixels. Left
    edges are marked in ``left_color`` on the top half, right edges in
    ``right_color`` on the bottom half (reference ``:288-296``).
    """
    out = _to_uint8(img).copy()
    h, w = out.shape[:2]
    half = h // 2
    for l in range(0, len(locs_cw_px), 2):
        c, hw_ = int(locs_cw_px[l]), int(locs_cw_px[l + 1])
        if hw_ <= 0:
            continue
        x, y = c - hw_, c + hw_
        out[:half, max(0, x - pad):min(x + pad, w)] = left_color
        out[half:, max(0, y - 1):min(y + 1, w)] = right_color
    return out


def hstack_chars(chars: np.ndarray, max_chars: int = 16) -> np.ndarray:
    """(N, H, W, 3) [-1,1] glyph crops -> one horizontal uint8 strip."""
    n = min(len(chars), max_chars)
    return _to_uint8(np.concatenate(list(chars[:n]), axis=1))


def build_visual_grids(gt: np.ndarray, lq: np.ndarray, sr: np.ndarray,
                       prior128: np.ndarray, gt_chars: np.ndarray,
                       pred_cw: np.ndarray, boxinfo_lr: np.ndarray,
                       pred_ids: np.ndarray,
                       font_path: Optional[str] = None, show_num: int = 2
                       ) -> Tuple[Dict[str, np.ndarray], str]:
    """Assemble the reference's TB panels for the first ``show_num`` samples.

    Args (host numpy, first axis = batch):
      gt: (B, 128, 2048, 3); lq: (B, 32, 512, 3); sr: (B, 128, 2048, 3);
      prior128 / gt_chars: (B, 16, 128, 128, 3);
      pred_cw: (B, 32) normalized (center, half-width);
      boxinfo_lr: (B, 32) normalized (left, right);
      pred_ids: (B, T) encoder argmax ids.
    Returns ({label: HWC uint8 grid}, the first sample's predicted text),
    labels mirroring the reference's; with ``font_path`` the text is also
    drawn as the ``1_pred_text`` panel.
    """
    b = min(show_num, gt.shape[0])
    big_w = gt.shape[2]
    grids: Dict[str, np.ndarray] = {}

    rows_gt_sr = []
    rows_locs = []
    for i in range(b):
        lq_up = resize(lq[i], (gt.shape[2], gt.shape[1]), INTER_LINEAR)
        rows_gt_sr += [_to_uint8(gt[i]), _to_uint8(sr[i]),
                       _to_uint8(lq_up)]
        # pred locs on the upscaled LQ; GT box edges on the GT image
        rows_locs.append(draw_locs_overlay(lq_up, pred_cw[i] * big_w))
        gt_cw = np.empty_like(boxinfo_lr[i])
        gt_cw[0::2] = (boxinfo_lr[i][0::2] + boxinfo_lr[i][1::2]) / 2
        gt_cw[1::2] = (boxinfo_lr[i][1::2] - boxinfo_lr[i][0::2]) / 2
        rows_locs.append(draw_locs_overlay(
            gt[i], gt_cw * big_w, left_color=(0, 255, 0),
            right_color=(0, 255, 0), pad=1))
    grids["1_gt_sr_lq"] = np.concatenate(rows_gt_sr, axis=0)
    grids["2_pred_locs"] = np.concatenate(rows_locs, axis=0)

    text = ctc_collapse_ids(pred_ids[0])
    if font_path:
        grids["1_pred_text"] = render_text_row(text, font_path)

    grids["3_char_gt"] = hstack_chars(gt_chars[0])
    grids["3_char_prior"] = hstack_chars(prior128[0])
    return grids, text
