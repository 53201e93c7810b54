"""The port's float resizes and ``filter2d`` (``marconet_tpu_torch/utils/
image.py``) against OpenCV, which the JAX package's data path calls and
the card's machine lacks.

OpenCV with its IPP layer off (fixture ``no_ipp``; IPP computes other
resizes). Inputs are [0, 1] float32 images; the bound is 1e-5 max abs in
every interpolation (``INTER_LINEAR`` 1, ``INTER_CUBIC`` 2, ``INTER_AREA``
3, ``INTER_LANCZOS4`` 4), shrinking, enlarging and mixed, odd sizes, one
and three channels, and for ``filter2D`` with ``BORDER_REFLECT_101`` at
every kernel size the degradations use. The port follows OpenCV's own
order of f32 operations, so on this OpenCV build the results are equal
bit for bit, which the degradation parity (``test_torch_degrade.py``)
relies on; the count of unequal values is printed.
"""

import cv2
import numpy as np
import pytest

from marconet_tpu_torch.utils import image as timage

TOL = 1e-5
MODES = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
         "area": cv2.INTER_AREA, "lanczos4": cv2.INTER_LANCZOS4}
# (h, w) -> (out_w, out_h): up, down, integer down (area's block mean),
# fractional down (area's tables), mixed, odd sizes, one-pixel sides
SIZES = [((37, 53), (106, 74)), ((37, 53), (17, 11)), ((36, 54), (18, 12)),
         ((36, 54), (12, 12)), ((128, 700), (413, 61)),
         ((64, 301), (512, 32)), ((31, 17), (29, 40)), ((40, 90), (23, 97)),
         ((1, 9), (4, 3)), ((5, 1), (7, 2)), ((128, 2048), (700, 40)),
         ((32, 96), (384, 128)), ((36, 54), (27, 18)),
         ((40, 60), (20, 10)), ((40, 64), (32, 20))]


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def test_mode_codes_are_opencvs():
    """The data path draws these codes from the JAX package's lists."""
    assert (timage.INTER_LINEAR, timage.INTER_CUBIC, timage.INTER_AREA,
            timage.INTER_LANCZOS4) == (cv2.INTER_LINEAR, cv2.INTER_CUBIC,
                                       cv2.INTER_AREA, cv2.INTER_LANCZOS4)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_matches_opencv(no_ipp, mode, channels):
    rng = np.random.default_rng(channels * 10 + MODES[mode])
    unequal = 0
    for (h, w), size in SIZES:
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.uniform(0, 1, shape).astype(np.float32)
        want = cv2.resize(img, size, interpolation=MODES[mode])
        got = timage.resize(img, size, MODES[mode])
        assert got.shape == want.shape and got.dtype == want.dtype
        err = float(np.abs(got - want).max())
        assert err <= TOL, ((h, w), size, err)
        unequal += int((got != want).sum())
    print(f"{mode} x{channels}: {unequal} values differ from OpenCV")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_resize_same_size_and_float64(no_ipp, mode):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (20, 30, 3))
    assert np.array_equal(timage.resize(img.astype(np.float32), (30, 20),
                                        MODES[mode]), img.astype(np.float32))
    want = cv2.resize(img, (47, 9), interpolation=MODES[mode])
    got = timage.resize(img, (47, 9), MODES[mode])
    assert got.dtype == np.float64
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("size,shape", [((0, 5), (4, 4, 3)),
                                        ((5, 0), (4, 4, 3)),
                                        ((5, 5), (0, 4, 3))])
def test_resize_refuses_empty(size, shape):
    """cv2 raises on an empty image or size (the data path relies on the
    exception: a degradation that fails falls back to the clean line)."""
    img = np.zeros(shape, np.float32)
    with pytest.raises(cv2.error):
        cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    with pytest.raises(ValueError):
        timage.resize(img, size, timage.INTER_LINEAR)


@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 11, 13, 15, 17, 21])
def test_filter2d_matches_opencv(no_ipp, ksize):
    """Direct (below 130 taps) and DFT (from 130 taps) paths of
    ``cv2.filter2D``, kernels with negative taps and zeros, images
    smaller than the kernel, one and three channels."""
    rng = np.random.default_rng(ksize)
    unequal = 0
    for shape in [(128, 700, 3), (20, 31, 3), (5, 7, 3), (3, 2, 3),
                  (33, 45)]:
        img = rng.uniform(0, 1, shape).astype(np.float32)
        kernel = rng.uniform(-0.2, 1, (ksize, ksize)).astype(np.float32)
        kernel[0, ksize // 2] = 0.0
        kernel /= kernel.sum()
        want = cv2.filter2D(img, -1, kernel,
                            borderType=cv2.BORDER_REFLECT_101)
        got = timage.filter2d(img, kernel)
        assert got.shape == want.shape and got.dtype == np.float32
        err = float(np.abs(got - want).max())
        assert err <= TOL, (shape, err)
        unequal += int((got != want).sum())
    print(f"filter2d {ksize}x{ksize}: {unequal} values differ from OpenCV")


def test_filter2d_refuses_even_kernel():
    with pytest.raises(ValueError):
        timage.filter2d(np.zeros((4, 4, 3), np.float32),
                        np.ones((4, 4), np.float32))
