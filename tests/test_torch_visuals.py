"""The port's validation grids (``marconet_tpu_torch/train/visuals.py``)
against the JAX package's on the same arrays: every image panel within
one uint8 level at no more than 0.1% of the values (the JAX side's cv2
linear upsample of the LQ line against ``utils/image.resize``), and the
predicted text, which the JAX package renders with PIL
(``1_pred_text``) and the port returns as text."""

import cv2
import numpy as np
import pytest

from marconet_tpu.alphabet import BLANK_INDEX
from marconet_tpu.train import visuals as jvisuals
from marconet_tpu_torch.train import visuals as tvisuals


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _arrays(seed: int, b: int = 2, n: int = 4):
    rng = np.random.default_rng(seed)
    w = 128 * n

    def img(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    box = np.sort(rng.uniform(0, 1, (b, 2 * n)), axis=1).astype(np.float32)
    box[:, -2:] = 0.0                      # an empty slot
    cw = rng.uniform(0, 0.2, (b, 2 * n)).astype(np.float32)
    ids = rng.integers(0, BLANK_INDEX + 1, (b, 2 * n))
    ids[:, 1] = ids[:, 0]                  # a repeat to collapse
    ids[:, 3] = BLANK_INDEX
    return dict(gt=img(b, 128, w, 3), lq=img(b, 32, w // 4, 3),
                sr=img(b, 128, w, 3), prior128=img(b, n, 128, 128, 3),
                gt_chars=img(b, n, 128, 128, 3), pred_cw=cw,
                boxinfo_lr=box, pred_ids=ids)


@pytest.mark.parametrize("seed", range(3))
def test_grids_match_jax(no_ipp, seed):
    arrays = _arrays(seed)
    want = jvisuals.build_visual_grids(**arrays)
    grids, text = tvisuals.build_visual_grids(**arrays)
    assert set(grids) | {"1_pred_text"} == set(want)
    for label, img in grids.items():
        assert img.dtype == np.uint8 and img.shape == want[label].shape
        levels = np.abs(img.astype(np.int16) - want[label])
        assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3, label
    assert text == jvisuals.ctc_collapse_ids(arrays["pred_ids"][0])


def test_ctc_collapse_and_panels_match_jax():
    ids = np.array([5, 5, BLANK_INDEX, 5, 17, 6734, 6734, BLANK_INDEX])
    assert tvisuals.ctc_collapse_ids(ids) == jvisuals.ctc_collapse_ids(ids)
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (64, 300, 3)).astype(np.float32)
    locs = np.array([40.0, 10.0, 150.0, 0.0, 290.0, 20.0, 5.0, 9.0])
    np.testing.assert_array_equal(
        tvisuals.draw_locs_overlay(img, locs, pad=1),
        jvisuals.draw_locs_overlay(img, locs, pad=1))
    chars = rng.uniform(-1, 1, (20, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvisuals.hstack_chars(chars),
                                  jvisuals.hstack_chars(chars))
