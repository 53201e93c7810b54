"""The port's paired degradation (``marconet_tpu_torch/data/degrade/
paired.py``) against the JAX package's on the same seeds.

* The sequence: the same steps and parameters from the same seed, and the
  generator left in the same state.
* The pairs: equal to the JAX package's within ``tests/
  test_torch_degrade.py``'s bound (1e-4, else at most one uint8 level on
  0.1% of values), OpenCV with its IPP layer off (its resizes are then the
  port's ``utils/image.resize``, as ``tests/test_torch_resize_cv2.py``
  holds them). The JAX module's JPEG step runs libjpeg through cv2,
  unpatched; the port's runs its libjpeg-exact round trip, and the two
  steps are held equal on their own (``test_jpeg_step_deviation``).
"""

import cv2
import numpy as np
import pytest

from marconet_tpu.data.degrade import paired as jpaired
from marconet_tpu_torch.data.degrade import paired as tpaired
from marconet_tpu_torch.utils import image as timage
from tests.test_torch_degrade import (  # noqa: F401  (no_ipp: fixture)
    _assert_close,
    _line,
    _twins,
    no_ipp,
)

SEEDS = range(24)


def _same_seq(got, want):
    assert [s["type"] for s in got] == [s["type"] for s in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "kernel":
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]), k


@pytest.mark.parametrize("sf", [2, 4])
def test_sequences_match_jax(sf):
    kinds = set()
    for seed in SEEDS:
        rj, rt = _twins(seed)
        want = jpaired.get_degrade_seq(rj, sf)
        got = tpaired.get_degrade_seq(rt, sf)
        _same_seq(got, want)
        assert rj.bit_generator.state == rt.bit_generator.state
        kinds |= {s["type"] for s in got}
    assert kinds == {"blur", "resize", "noise", "jpeg", "camera"}


def test_pairs_match_jax(no_ipp):
    modes = set()
    for seed in SEEDS:
        a = _line(seed)
        b = _line(seed + 100)[:, :a.shape[1]]
        rj, rt = _twins(seed)
        want = jpaired.degrade_pair(rj, a, b)
        got = tpaired.degrade_pair(rt, a, b)
        assert rj.bit_generator.state == rt.bit_generator.state
        for g, w, name in zip(got, want, "ab"):
            assert g.dtype == w.dtype == np.float32
            _assert_close(g, w, ("degrade_pair", seed, name))
        rs = np.random.default_rng(seed)
        modes |= {s.get("mode") for s in tpaired.get_degrade_seq(rs)}
    assert modes >= {timage.INTER_LINEAR, timage.INTER_CUBIC,
                     timage.INTER_AREA}


def test_paired_resize_modes_are_opencvs(no_ipp):
    """The three modes the sequence draws, at the scales it draws (1/8 to
    1), against cv2 on a text line: within 1e-5, as
    ``tests/test_torch_resize_cv2.py``."""
    img = _line(3)
    rng = np.random.default_rng(5)
    for mode in tpaired._MODES:
        for _ in range(4):
            s = 1.0 / rng.uniform(1.0, 8.0)
            size = (max(int(img.shape[1] * s), 1),
                    max(int(img.shape[0] * s), 1))
            want = cv2.resize(img, size, interpolation=mode)
            got = timage.resize(img, size, mode)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_jpeg_step_deviation():
    """libjpeg (the JAX module's step) against ``jpeg_u8``: no deviation,
    equal values at qualities 30-86 (the port substituted a numpy DCT
    round trip here once, ~2.5 levels mean from libjpeg)."""
    for seed in range(8):
        img = _line(seed)
        q = 30 + 8 * seed
        got = tpaired.jpeg_u8(img, q)
        want = jpaired.apply_degrade_seq(img, [{"type": "jpeg",
                                                "quality": q}])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
