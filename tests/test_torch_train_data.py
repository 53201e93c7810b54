"""The port's cv2-free training-batch preparation against the JAX
package's (which resizes wide glyphs with cv2).

Exact equality on the batch: both sides compute the same f32 arithmetic
in numpy, and on the {-1, 1} glyph masks the batch resizes the port's
``resize_width_linear`` reproduces OpenCV's ``INTER_LINEAR`` bit for bit.
On a smooth image it stays within one f32 ulp of OpenCV (whose vectorized
float path rounds the two-tap sum in its own order).
"""

import cv2
import numpy as np
import pytest

from marconet_tpu.alphabet import BLANK_INDEX
from marconet_tpu.data import batch_prep as jprep
from marconet_tpu_torch.data import batch_prep as tprep


def _batch(rng, b=2, n_chars=4):
    """Random GT / ink / LQ lines with one box wider than 128 px (the
    resized glyph), a blank label with a box, truncated edge boxes and
    empty slots."""
    w = 128 * n_chars
    gt = rng.uniform(-1, 1, (b, 128, w, 3)).astype(np.float32)
    ink = (rng.uniform(0, 1, (b, 128, w, 3)) > 0.7).astype(np.float32)
    lq = rng.uniform(-1, 1, (b, 32, w // 4, 3)).astype(np.float32)
    labels = np.full((b, n_chars), BLANK_INDEX, np.int64)
    box = np.zeros((b, 2 * n_chars), np.float32)
    # line 0: a 200 px wide glyph, a left-edge glyph, a blank-labelled box
    labels[0, :3] = [17, 4000, BLANK_INDEX]
    box[0, :6] = [0.30, 0.30 + 200 / w, 0.0, 0.04, 0.8, 0.85]
    # line 1: right-edge glyph and an ordinary one
    labels[1, :2] = [5, 6734]
    box[1, :4] = [0.96, 1.0, 0.4, 0.45]
    return gt, ink, labels, box, lq


def test_prepare_train_batch_matches_jax():
    args = _batch(np.random.default_rng(0))
    want = jprep.prepare_train_batch(*args)
    got = tprep.prepare_train_batch(*args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the wide glyph was resized, not centered
    assert got["char_valid"][0].tolist() == [1, 1, 0, 0]
    assert got["box_valid"][0].tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize("width", [129, 150, 256, 301, 777])
def test_resize_width_linear_matches_cv2(width):
    rng = np.random.default_rng(width)
    crop = (rng.uniform(0, 1, (128, width, 3)) > 0.5).astype(
        np.float32) * 2 - 1
    want = cv2.resize(crop, (128, 128), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tprep.resize_width_linear(crop, 128), want)
    # and a smooth image in [-1, 1]: one f32 ulp at 1 is 1.2e-7
    img = rng.uniform(-1, 1, (8, width, 3)).astype(np.float32)
    want = cv2.resize(img, (128, 8), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(tprep.resize_width_linear(img, 128), want,
                               rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("center", [0, 30, 64, 500, 1990, 2047])
def test_crop_taps_and_glyph_canvas_match_jax(center):
    for got, want in zip(tprep._crop_taps(center), jprep._crop_taps(center)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(center)
    ink = (rng.uniform(0, 1, (128, 2048, 3)) > 0.5).astype(np.float32)
    for l_px, r_px in ((center, center), (center, center + 40),
                       (max(center - 150, 0), center + 10)):
        np.testing.assert_array_equal(
            tprep.glyph_canvas(ink, l_px, r_px),
            jprep.glyph_canvas(ink, l_px, r_px))
