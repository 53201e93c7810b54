"""A seeded glyph renderer for the port's data-path and loop tests.

``TextLineSynthesizer.render`` draws text with PIL and a TrueType font in
the JAX package and raises in the port (no PIL on the card's machine, no
font pack in the repository). :func:`stroke_render` stands in for it on
both sides: it draws each character of a sampled text as a few seeded
strokes, with the same return contract (image, ink mask, text, labels,
per-character pixel columns), so the rest of ``sample`` -- the
degradations, the LQ resize and padding, ``batch`` and
``prepare_train_batch`` -- runs as in training. It is a module-level
function and :class:`StrokeSynthesizer` a module-level class, so spawned
batch workers can unpickle them.
"""

import numpy as np

from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.data.synth import (
    CHECK_NUM,
    GT_H,
    GT_W,
    SynthConfig,
    TextLineSynthesizer,
)


def stroke_render(self, rng, bg_rgb, forced_text=None):
    """``render``'s contract with seeded strokes for glyphs."""
    if forced_text is not None:
        text = forced_text
        labels = [alphabet().find(c) for c in text]
    else:
        text, labels = self.sample_text(rng)
        tries = 0
        while (not text or len(text) > CHECK_NUM) and tries < 10:
            text, labels = self.sample_text(rng)
            tries += 1
    if not text:
        return None
    img = np.array(bg_rgb, np.float32, copy=True)
    ink = np.zeros((GT_H, GT_W), np.float32)
    x = int(rng.integers(0, 24))
    char_locs = []
    for _ in text:
        w = int(rng.integers(40, 100))
        if x + w > GT_W:
            return None
        top, bottom = int(rng.integers(10, 40)), int(rng.integers(88, 118))
        for _ in range(int(rng.integers(2, 5))):
            if rng.random() < 0.5:           # a vertical stroke
                c0 = x + int(rng.integers(0, w - 8))
                ink[top:bottom, c0:c0 + int(rng.integers(4, 9))] = 1.0
            else:                            # a horizontal stroke
                r0 = int(rng.integers(top, bottom - 6))
                ink[r0:r0 + int(rng.integers(3, 7)), x:x + w] = 1.0
        char_locs += [x, x + w - 1]
        x += w + int(rng.integers(4, 20))
    max_width = max(char_locs)
    char_locs += [GT_W, GT_W] * (CHECK_NUM - len(text))
    color = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    img[ink > 0] = color
    mask = np.repeat(ink[:, :, None], 3, axis=2)
    offset_w = min(max_width + int(rng.integers(0, 17)), GT_W) // 4 * 4
    return img[:, :offset_w], mask[:, :offset_w], text, labels, char_locs


class StrokeSynthesizer(TextLineSynthesizer):
    """The port's synthesizer with :func:`stroke_render` for glyphs."""

    render = stroke_render


def stroke_synthesizer(bg_dir: str = "") -> StrokeSynthesizer:
    """A picklable factory for ``BatchLoader`` workers."""
    return StrokeSynthesizer(SynthConfig(bg_dir=bg_dir))
