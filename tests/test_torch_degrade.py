"""The port's degradation data path (``marconet_tpu_torch/data/imutils.py``
and ``data/degrade/*``) against the JAX package's, on the same
``np.random.Generator`` seeds.

Every case checks that both generators end in the same state (the same
draws in the same order) and that the outputs agree: within 1e-4
elementwise, or, where the output is quantised to uint8 levels, within
one level at no more than 0.1% of the values. The JAX package runs cv2;
the port runs ``utils/image.resize`` / ``filter2d``, which follow
OpenCV's f32 arithmetic (``test_torch_resize_cv2.py``) -- needed here,
because the Poisson noise draws its rate from the count of distinct
levels in the image, so a one-ulp difference upstream can change every
value downstream.

One substitution, a documented deviation of the JAX side's environment,
not of the port: Real-ESRGAN's JPEG in the JAX package is
``data/native.jpeg_roundtrip``, the C++ helper when it builds and
``diffjpeg.jpeg_np`` otherwise; the parity cases pin it to ``jpeg_np``
(what the port runs), and :func:`test_jpeg_np_matches_native` bounds the
helper's distance. BSRGAN's ``_add_jpeg`` is libjpeg through cv2 in the
JAX package and ``utils/jpeg.jpeg_roundtrip_u8`` in the port, which gives
libjpeg's bytes: the parity cases run both unpatched, and
:func:`test_bsrgan_jpeg_deviation` holds the two equal.
"""

import cv2
import numpy as np
import pytest

from marconet_tpu.data import imutils as jimutils
from marconet_tpu.data import native as jnative
from marconet_tpu.data.degrade import bsrgan as jbsrgan
from marconet_tpu.data.degrade import camera_isp as jisp
from marconet_tpu.data.degrade import diffjpeg as jdiffjpeg
from marconet_tpu.data.degrade import kernels as jkernels
from marconet_tpu.data.degrade import noise as jnoise
from marconet_tpu.data.degrade import realesrgan as jrealesrgan
from marconet_tpu_torch.data import imutils as timutils
from marconet_tpu_torch.data.degrade import bsrgan as tbsrgan
from marconet_tpu_torch.data.degrade import camera_isp as tisp
from marconet_tpu_torch.data.degrade import diffjpeg as tdiffjpeg
from marconet_tpu_torch.data.degrade import kernels as tkernels
from marconet_tpu_torch.data.degrade import noise as tnoise
from marconet_tpu_torch.data.degrade import realesrgan as trealesrgan

TOL = 1e-4
LEVEL_SHARE = 1e-3
SEEDS = range(20)


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _line(seed: int) -> np.ndarray:
    """A 128-high RGB line in [0, 1]: a smooth field with ink-like bars."""
    rng = np.random.default_rng(1000 + seed)
    w = int(rng.integers(24, 160)) * 4
    img = rng.uniform(0, 1, (128, w, 3)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 3)
    for _ in range(w // 40):
        x = int(rng.integers(0, w - 8))
        img[16:112, x:x + int(rng.integers(3, 9))] = rng.uniform(0, 1, 3)
    return img


def _twins(seed: int):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    if err <= TOL:
        return
    levels = np.abs(np.round(got * 255.0) - np.round(want * 255.0))
    share = float((levels > 0).mean())
    assert levels.max() <= 1 and share <= LEVEL_SHARE, \
        (what, err, float(levels.max()), share)


def _assert_same_draws(r_jax, r_port, what):
    assert r_jax.bit_generator.state == r_port.bit_generator.state, what


# -- imutils ----------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.25, 0.5, 1 / 3, 0.7, 1.5, 2.0, 4.0])
@pytest.mark.parametrize("antialiasing", [True, False])
def test_imresize_np_matches_jax(scale, antialiasing):
    img = np.random.default_rng(0).uniform(0, 1, (37, 53, 3)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        timutils.imresize_np(img, scale, antialiasing),
        jimutils.imresize_np(img, scale, antialiasing))
    np.testing.assert_array_equal(
        timutils.imresize_np(img[..., 0], scale, antialiasing),
        jimutils.imresize_np(img[..., 0], scale, antialiasing))


def test_imutils_converters_augment_and_color_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.1, 1.1, (9, 14, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timutils.single2uint(img),
                                  jimutils.single2uint(img))
    np.testing.assert_array_equal(timutils.uint2single(u8),
                                  jimutils.uint2single(u8))
    for mode in range(8):
        np.testing.assert_array_equal(timutils.augment_img(img, mode),
                                      jimutils.augment_img(img, mode))
    for x in (np.clip(img, 0, 1), u8):
        for only_y in (True, False):
            np.testing.assert_array_equal(
                timutils.rgb2ycbcr(x, only_y), jimutils.rgb2ycbcr(x, only_y))
        np.testing.assert_array_equal(timutils.ycbcr2rgb(x),
                                      jimutils.ycbcr2rgb(x))
    with pytest.raises(ValueError):
        timutils.augment_img(img, 8)


# -- kernels, noise, camera ISP ----------------------------------------------


def test_kernels_match_jax():
    cases = [("bivariate_gaussian", (13, 1.5)),
             ("bivariate_gaussian", (13, 1.5, 0.5, 0.3, None, False)),
             ("bivariate_generalized_gaussian", (13, 1.5, 0.8, 0.2, 2.0,
                                                 False)),
             ("bivariate_plateau", (13, 1.5, 0.8, 0.2, 1.5, False)),
             ("circular_lowpass_kernel", (np.pi / 2, 13)),
             ("circular_lowpass_kernel", (np.pi / 2, 13, 21)),
             ("fspecial_gaussian", (15, 0.5)),
             ("anisotropic_gaussian", (11, 0.7, 2.0, 4.0))]
    for name, args in cases:
        np.testing.assert_array_equal(getattr(tkernels, name)(*args),
                                      getattr(jkernels, name)(*args), name)
    x = np.random.default_rng(2).uniform(0, 1, (15, 15, 3))
    for sf in (2, 3, 4):
        for upper_left in (True, False):
            np.testing.assert_array_equal(
                tkernels.shift_pixel(x, sf, upper_left),
                jkernels.shift_pixel(x, sf, upper_left))


@pytest.mark.parametrize("seed", range(5))
def test_random_mixed_kernel_matches_jax(seed):
    names = ["iso", "aniso", "generalized_iso", "generalized_aniso",
             "plateau_iso", "plateau_aniso"]
    probs = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]
    rj, rt = _twins(seed)
    for _ in range(20):
        np.testing.assert_array_equal(
            tkernels.random_mixed_kernel(rt, names, probs, 13, (0.2, 3),
                                         (0.2, 3)),
            jkernels.random_mixed_kernel(rj, names, probs, 13, (0.2, 3),
                                         (0.2, 3)))
    _assert_same_draws(rj, rt, "random_mixed_kernel")


@pytest.mark.parametrize("seed", range(5))
def test_noise_matches_jax(seed):
    img = _line(seed)[:, :96]
    rj, rt = _twins(seed)
    for gray in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(
            tnoise.gaussian_noise(rt, img, (1, 20), gray),
            jnoise.gaussian_noise(rj, img, (1, 20), gray))
        np.testing.assert_array_equal(
            tnoise.poisson_noise(rt, img, (0.05, 3), gray),
            jnoise.poisson_noise(rj, img, (0.05, 3), gray))
    _assert_same_draws(rj, rt, "noise")


@pytest.mark.parametrize("seed", range(5))
def test_camera_isp_matches_jax(no_ipp, seed):
    img = _line(seed)[:, :101]          # odd width: a column passes through
    rj, rt = _twins(seed)
    _assert_close(tisp.camera_isp_noise(rt, img),
                  jisp.camera_isp_noise(rj, img), "camera_isp_noise")
    _assert_same_draws(rj, rt, "camera_isp_noise")


# -- JPEG --------------------------------------------------------------------


@pytest.mark.parametrize("quality", [30.5, 50.0, 77.3, 95.0])
def test_jpeg_np_matches_jax(quality):
    rng = np.random.default_rng(int(quality))
    for shape in [(37, 53, 3), (128, 700, 3), (16, 16, 3), (5, 3, 3)]:
        img = rng.uniform(0, 1, shape).astype(np.float32)
        np.testing.assert_array_equal(tdiffjpeg.jpeg_np(img, quality),
                                      jdiffjpeg.jpeg_np(img, quality))


# the batched torch round trip against the JAX package's ``diff_jpeg``:
# (B, H, W, 3) with H, W not multiples of 16, per-image and one quality
DIFF_JPEG_SHAPE = (2, 37, 53, 3)


def _diff_jpeg_inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, DIFF_JPEG_SHAPE).astype(np.float32)
    return x, rng.uniform(-1, 1, DIFF_JPEG_SHAPE).astype(np.float32)


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("quality", [(35.0, 80.0), 62.5])
def test_diff_jpeg_matches_jax(differentiable, quality):
    """Forward within 1e-5 of JAX's (outputs in [0, 1])."""
    import jax.numpy as jnp
    import torch

    x, _ = _diff_jpeg_inputs(7)
    want = np.asarray(jdiffjpeg.diff_jpeg(jnp.asarray(x),
                                          jnp.asarray(quality),
                                          differentiable=differentiable))
    got = tdiffjpeg.diff_jpeg(torch.from_numpy(x), torch.tensor(quality),
                              differentiable=differentiable).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_diff_jpeg_gradient_matches_jax():
    """The gradient of a weighted sum of the soft-rounded round trip by
    autograd against ``jax.grad``, within 1e-4."""
    import jax
    import jax.numpy as jnp
    import torch

    x, wts = _diff_jpeg_inputs(8)
    quality = (40.0, 90.0)

    def loss(v):
        return (jdiffjpeg.diff_jpeg(v, jnp.asarray(quality),
                                    differentiable=True) * wts).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tdiffjpeg.diff_jpeg(xt, torch.tensor(quality), differentiable=True)
     * torch.from_numpy(wts)).sum().backward()
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-4)


def test_diff_jpeg_matches_jpeg_np():
    """Without the surrogate, each image of the batch is ``jpeg_np``'s
    round trip at its own quality (within 1e-5)."""
    import torch

    x, _ = _diff_jpeg_inputs(9)
    quality = (30.5, 77.3)
    got = tdiffjpeg.diff_jpeg(torch.from_numpy(x), torch.tensor(quality))
    for i, q in enumerate(quality):
        np.testing.assert_allclose(got[i].numpy(),
                                   tdiffjpeg.jpeg_np(x[i], q), rtol=0,
                                   atol=1e-5)


def test_jpeg_np_matches_native():
    """The JAX package's C++ JPEG helper computes the same round trip in
    its own float order: within 1e-6 (the largest difference is printed)."""
    if not jnative.available():
        pytest.skip("the JAX package's native helper did not build here")
    rng = np.random.default_rng(3)
    worst = 0.0
    for shape in [(37, 53, 3), (128, 700, 3), (5, 3, 3)]:
        img = rng.uniform(0, 1, shape).astype(np.float32)
        for quality in (30.5, 50.0, 95.0):
            got = tdiffjpeg.jpeg_np(img, quality)
            want = jnative.jpeg_roundtrip(img, quality)
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"jpeg_np vs the native helper: {worst:.3e}")
    assert worst <= 1e-6


def test_bsrgan_jpeg_deviation():
    """libjpeg (cv2) against the port's ``_add_jpeg`` on 20 text-like
    lines at the qualities it draws: no deviation, equal bytes (the port
    substituted a numpy DCT round trip here once, 2.381 levels mean from
    libjpeg)."""
    for seed in SEEDS:
        img = _line(seed)
        rj, rt = _twins(seed)
        got = tbsrgan._add_jpeg(rt, img)
        want = jbsrgan._add_jpeg(rj, img)
        _assert_same_draws(rj, rt, "_add_jpeg")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -- the two pipelines -------------------------------------------------------


@pytest.mark.parametrize("insf", [1, 2, 3])
def test_real_esrgan_matches_jax(no_ipp, monkeypatch, insf):
    monkeypatch.setattr(jrealesrgan, "jpeg_np", jdiffjpeg.jpeg_np)
    for seed in SEEDS:
        img = _line(seed)
        rj, rt = _twins(seed)
        want = jrealesrgan.real_esrgan_degradation(img, insf, rng=rj)
        got = trealesrgan.real_esrgan_degradation(img, insf, rng=rt)
        _assert_same_draws(rj, rt, ("real_esrgan", seed, insf))
        _assert_close(got, want, ("real_esrgan", seed, insf))


@pytest.mark.parametrize("insf", [1, 2, 3])
def test_bsrgan_matches_jax(no_ipp, insf):
    for seed in SEEDS:
        img = _line(seed)
        rj, rt = _twins(seed)
        want_lq, want_hq = jbsrgan.bsrgan_degradation(img, insf, rng=rj)
        got_lq, got_hq = tbsrgan.bsrgan_degradation(img, insf, rng=rt)
        _assert_same_draws(rj, rt, ("bsrgan", seed, insf))
        _assert_close(got_lq, want_lq, ("bsrgan", seed, insf))
        np.testing.assert_array_equal(got_hq, want_hq)
