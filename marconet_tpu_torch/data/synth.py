"""Synthetic text-line rendering + degradation dataset (host-side).

Counterpart of ``marconet_tpu/data/synth.py`` with the same random draws
in the same order, everything but the glyph rendering: ``render`` draws
text with PIL and a TrueType font in the JAX package, and the card's
machine has no PIL and the repository no font pack, so here it raises
(subclasses provide a renderer). Backgrounds are read as cv2 reads them
(``utils/imread.py``), with the flat fallback wherever cv2 gives None;
the resizes are ``utils/image.resize``.

Behavioural port of the reference's ``TextDegradationDataset``
(``Train/tspgan/data/text_degradation_dataset.py:23-435``) re-organized for
a clean host pipeline:

* text sampling: 50% corpus lines (3 sub-corpora at 0.3/0.3/0.4), 30%
  random alphabet characters, 20% latin/digit strings (``:292-350``);
* PIL rendering with random font/size(90-140)/offset/color, white-bg swap
  p=0.08, black text p=0.1 (``:157-243``);
* per-character x-extents recovered by incremental re-rendering +
  vertical projection (``:181-204``);
* background: thin random slivers of DF2K patches stretched to 128x2048
  (``:263-280``);
* torchvision-style brightness/contrast/saturation jitter in random order
  (``:123-143,364-369``);
* degradation choice: 55% Real-ESRGAN / 44% BSRGAN / 1% clean with
  insf drawn from {1,2,2,3,3,3}; exceptions fall back to clean
  (``:373-394``);
* LQ resized to height 32 with a random interpolation, GT/mask/LQ
  zero-padded to 2048/512 wide, labels blank-padded, boxinfo normalized
  (``:396-432``).

Outputs are NHWC numpy, RGB, GT/LQ normalized to [-1, 1].
"""

from __future__ import annotations

import os
import string
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from marconet_tpu_torch.alphabet import BLANK_INDEX, alphabet
from marconet_tpu_torch.data.batch_prep import prepare_train_batch
from marconet_tpu_torch.data.degrade import (
    bsrgan_degradation,
    real_esrgan_degradation,
)
from marconet_tpu_torch.utils.image import (
    INTER_CUBIC,
    INTER_LANCZOS4,
    INTER_LINEAR,
    resize,
)
from marconet_tpu_torch.utils.imread import imread

CHECK_NUM = 16
GT_H, GT_W = 128, 128 * CHECK_NUM
LQ_H, LQ_W = 32, 32 * CHECK_NUM


@dataclass
class SynthConfig:
    font_dir: str = ""
    bg_dir: str = ""
    corpus_paths: Sequence[str] = ()
    min_text_length: int = 4
    max_text_length: int = 16
    brightness: Tuple[float, float] = (0.9, 1.1)
    contrast: Tuple[float, float] = (0.9, 1.1)
    saturation: Tuple[float, float] = (0.9, 1.1)
    degrade: bool = True


def _color_jitter(rng, img):
    """brightness/contrast/saturation in random order (torchvision
    semantics on a [0,1] RGB image)."""
    gray_w = np.array([0.299, 0.587, 0.114], np.float32)

    def bright(x, f):
        return np.clip(x * f, 0, 1)

    def contrast(x, f):
        m = (x @ gray_w).mean()
        return np.clip(f * x + (1 - f) * m, 0, 1)

    def sat(x, f):
        g = (x @ gray_w)[..., None]
        return np.clip(f * x + (1 - f) * g, 0, 1)

    ops = [(bright, (0.9, 1.1)), (contrast, (0.9, 1.1)), (sat, (0.9, 1.1))]
    for i in rng.permutation(3):
        fn, rngs = ops[i]
        img = fn(img, rng.uniform(*rngs))
    return img


class TextLineSynthesizer:
    """Text lines with their degraded LQ twins, everything but the glyph
    rendering: :meth:`render` raises, and a subclass supplies it (the
    JAX package draws text with PIL and a TrueType font of the font pack;
    the card's machine has no PIL and the repository no font pack)."""

    def __init__(self, config: SynthConfig):
        self.cfg = config
        chars = alphabet()
        self.latin = [c for c in chars if c in string.ascii_letters]
        self.digits = [c for c in chars if c in string.digits]

        self.corpora: List[List[str]] = []
        for path in config.corpus_paths:
            if path and os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    lines = [ln.strip() for ln in f.read().split("\n")]
                self.corpora.append(
                    [ln for ln in lines
                     if len(ln) > config.min_text_length])
        while self.corpora and len(self.corpora) < 3:
            self.corpora.append(self.corpora[0])

        self.bg_paths = []
        if config.bg_dir and os.path.isdir(config.bg_dir):
            self.bg_paths = [os.path.join(config.bg_dir, f)
                             for f in sorted(os.listdir(config.bg_dir))]

    # -- text sampling -----------------------------------------------------

    def sample_text(self, rng) -> Tuple[str, List[int]]:
        cfg = self.cfg
        chars = alphabet()
        p = rng.random()
        if p > 0.5 and self.corpora:
            q = rng.random()
            corpus = self.corpora[0 if q > 0.7 else (1 if q > 0.4 else 2)]
            text = corpus[rng.integers(0, len(corpus))]
        elif p > 0.2 or (p > 0.5 and not self.corpora):
            k = int(rng.integers(cfg.min_text_length,
                                 cfg.max_text_length + 1))
            idx = rng.integers(0, len(chars), k)
            text = "".join(chars[i] for i in idx)
        else:
            pool = self.latin + self.digits
            k = int(rng.integers(cfg.min_text_length,
                                 cfg.max_text_length + 1))
            text = "".join(pool[rng.integers(0, len(pool))]
                           for _ in range(k))
        text = "".join(text.split())[:64]
        if len(text) > CHECK_NUM:
            x0 = int(rng.integers(0, len(text) - CHECK_NUM + 1))
            span = int(rng.integers(cfg.min_text_length,
                                    cfg.max_text_length + 1))
            text = text[x0:x0 + min(span, cfg.max_text_length)]
        out_text, labels = "", []
        for ch in text:
            idx = chars.find(ch)
            if idx >= 0:
                out_text += ch
                labels.append(idx)
        return out_text, labels

    # -- rendering ---------------------------------------------------------

    def render(self, rng, bg_rgb: np.ndarray, forced_text=None):
        """Render text on a 128x2048 RGB background (the JAX package's
        ``TextLineSynthesizer.render``, ``synth.py:147-223``).

        Returns (img [0,1] (128, W, 3), ink mask {0,1} (128, W, 3), text,
        labels, char_locs: 2 * CHECK_NUM pixel columns, (left, right) per
        character, ``GT_W`` for unused slots) or None when the render is
        unusable (the caller retries). Not available here: it needs a
        TrueType renderer without PIL and the font pack, neither of which
        the repository has. Subclasses override it.
        """
        raise NotImplementedError(
            "TextLineSynthesizer.render needs glyph rendering: a TrueType "
            "renderer without PIL and the font pack (path_font, "
            f"{self.cfg.font_dir or 'unset'}), which the repository does "
            "not have; pass a synthesizer whose render is implemented")

    # -- background --------------------------------------------------------

    def background(self, rng) -> np.ndarray:
        if not self.bg_paths:
            # flat random-tinted background fallback
            base = rng.uniform(0.2, 1.0, 3).astype(np.float32)
            return np.broadcast_to(base, (GT_H, GT_W, 3)).copy()
        path = self.bg_paths[int(rng.integers(0, len(self.bg_paths)))]
        img = imread(path)
        if img is None:
            base = rng.uniform(0.2, 1.0, 3).astype(np.float32)
            return np.broadcast_to(base, (GT_H, GT_W, 3)).copy()
        img = img.astype(np.float32) / 255.0
        if rng.random() > 0.5:
            img = img[:, ::-1]
        size = int(rng.integers(320, 401))
        img = resize(img, (size, size), INTER_LINEAR)
        h0, w0 = img.shape[:2]
        h1 = int(rng.integers(0, h0 // 2))
        w1 = int(rng.integers(0, w0 // 4))
        crop = min(int(rng.integers(w0 // 4, w0 // 4 * 3)), 128)
        sliver = img[h1:h1 + max(crop // CHECK_NUM, 1), w1:w1 + crop]
        return resize(sliver, (GT_W, GT_H), INTER_LINEAR)

    # -- full sample -------------------------------------------------------

    def degrade(self, rng, rgb: np.ndarray) -> np.ndarray:
        """The LQ twin at its degraded size: 55% Real-ESRGAN, 44% BSRGAN,
        1% clean, ``insf`` from {1, 2, 2, 3, 3, 3}; a degradation that
        fails (tiny crops) falls back to clean."""
        lq = rgb
        if self.cfg.degrade:
            try:
                p = rng.random()
                insf = int(rng.choice([1, 2, 2, 3, 3, 3]))
                if p > 0.45:
                    lq = real_esrgan_degradation(rgb, insf=insf, rng=rng)
                elif p > 0.01:
                    lq, _ = bsrgan_degradation(rgb, sf=insf, rng=rng)
                else:
                    lq = rgb
            except Exception as e:  # degradations can fail on tiny crops
                print(["error degradation", rgb.shape, repr(e)])
                lq = rgb
        return np.clip(lq, 0, 1).astype(np.float32)

    def fit(self, rng, rgb: np.ndarray, mask: np.ndarray, lq: np.ndarray):
        """Resize the LQ line to height 32 with a drawn interpolation and
        zero-pad GT / mask to 2048 and LQ to 512 wide."""
        h_hq, w_hq = rgb.shape[:2]
        interp = int(rng.choice([INTER_LINEAR, INTER_CUBIC,
                                 INTER_LANCZOS4]))
        lq = resize(lq, (int(LQ_H * w_hq / h_hq), LQ_H), interp)

        gt_pad = np.zeros((GT_H, GT_W, 3), np.float32)
        mask_pad = np.zeros((GT_H, GT_W, 3), np.float32)
        lq_pad = np.zeros((LQ_H, LQ_W, 3), np.float32)
        gt_pad[:, :rgb.shape[1]] = rgb
        mask_pad[:, :mask.shape[1]] = mask
        if lq.shape[1] <= LQ_W:
            lq_pad[:, :lq.shape[1]] = lq
        else:
            lq_pad = resize(lq, (LQ_W, LQ_H), interp)
        return gt_pad, mask_pad, lq_pad

    def sample(self, rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
        rng = rng or np.random.default_rng()
        bg = self.background(rng)
        out = None
        attempts = 0
        while out is None or out[1].sum() < 1.0:
            forced = None
            if attempts >= 10:
                # fonts without CJK coverage can fail the per-char extent
                # check indefinitely; fall back to latin/digit text
                pool = (self.latin + self.digits) or list("0123456789")
                forced = "".join(pool[int(rng.integers(0, len(pool)))]
                                 for _ in range(6))
            out = self.render(rng, bg, forced_text=forced)
            attempts += 1
        rgb, mask, text, labels, char_locs = out
        rgb = _color_jitter(rng, rgb)
        lq = self.degrade(rng, rgb)
        gt_pad, mask_pad, lq_pad = self.fit(rng, rgb, mask, lq)

        label_arr = np.full(CHECK_NUM, BLANK_INDEX, np.int64)
        label_arr[:len(labels)] = labels

        return {
            "gt": gt_pad * 2.0 - 1.0,
            "mask": mask_pad,
            "label": label_arr,
            "lq": lq_pad * 2.0 - 1.0,
            "boxinfo": np.asarray(char_locs, np.float32) / GT_W,
            "text": text,
        }

    def batch(self, batch_size: int,
              rng: Optional[np.random.Generator] = None,
              max_chars: Optional[int] = None):
        """Synthesize a batch and attach the device-step extras.

        ``max_chars`` < 16 crops the line to the left ``max_chars*128``
        pixels and the slot arrays to ``max_chars`` (characters whose
        box crosses the crop are invalidated) — the data-side mirror of
        the model's reduced slot capacity (``MARCONetTrainer(max_chars=
        ...)``), used by the fast CI tier. Full-size training keeps the
        default (the synthesizer's native 16-slot, 2048-px line).
        """
        rng = rng or np.random.default_rng()
        samples = [self.sample(rng) for _ in range(batch_size)]
        stack = {k: np.stack([s[k] for s in samples])
                 for k in ("gt", "mask", "label", "lq", "boxinfo")}
        n_full = stack["label"].shape[1]
        if max_chars is not None and max_chars < n_full:
            b = stack["gt"].shape[0]
            full_w = stack["gt"].shape[2]
            w = full_w * max_chars // n_full
            stack["gt"] = stack["gt"][:, :, :w]
            stack["mask"] = stack["mask"][:, :, :w]
            stack["lq"] = stack["lq"][:, :, :w // 4]
            stack["label"] = stack["label"][:, :max_chars]
            # renormalize (left, right) pairs to the cropped width;
            # chars crossing the crop get a zero-width box -> invalid
            box = stack["boxinfo"].reshape(b, -1, 2)[:, :max_chars]
            box = box * (full_w / w)
            box[box[:, :, 1] > 1.0] = 0.0
            stack["boxinfo"] = np.clip(box, 0.0, 1.0).reshape(b, -1)
        return prepare_train_batch(stack["gt"], stack["mask"],
                                   stack["label"], stack["boxinfo"],
                                   stack["lq"])
