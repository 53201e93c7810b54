"""The port's text-line synthesizer (``marconet_tpu_torch/data/synth.py``)
against the JAX package's, everything but the glyph rendering.

One seeded renderer (``tests/torch_synth_support.stroke_render``) is
patched onto both classes, so ``sample`` -- background, render retries,
colour jitter, the degradation choice, the LQ resize and padding -- and
``batch`` (with and without the ``max_chars`` crop, through each side's
``prepare_train_batch``) run the same draws. Backgrounds: flat, a
directory of PNG patches, and one mixing a PNG, a JPEG, a BMP and an
unreadable file (cv2 reads them in the JAX package, ``utils/imread.py``
here). The JAX side's Real-ESRGAN JPEG is pinned to ``jpeg_np`` as in
``test_torch_degrade.py``; BSRGAN's ``_add_jpeg`` runs libjpeg through cv2
on the JAX side and the port's libjpeg-exact round trip here, unpatched.
Outputs equal within 1e-4, or within one uint8 level at no more than 0.1%
of the values; generator states equal.
"""

import cv2
import numpy as np
import pytest

from marconet_tpu.data import synth as jsynth
from marconet_tpu.data.degrade import diffjpeg as jdiffjpeg
from marconet_tpu.data.degrade import realesrgan as jrealesrgan
from marconet_tpu_torch.data import synth as tsynth
from tests.torch_synth_support import StrokeSynthesizer, stroke_render

TOL = 1e-4
LEVEL_SHARE = 1e-3


@pytest.fixture
def pinned(monkeypatch):
    """cv2 without IPP, the JAX side's Real-ESRGAN JPEG pinned, the
    renderer on the JAX class."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    monkeypatch.setattr(jrealesrgan, "jpeg_np", jdiffjpeg.jpeg_np)
    monkeypatch.setattr(jsynth.TextLineSynthesizer, "render", stroke_render)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def bg_dir(tmp_path_factory):
    """Four PNG background patches (RGB, RGBA and gray files)."""
    d = tmp_path_factory.mktemp("bg")
    rng = np.random.default_rng(7)
    for i, channels in enumerate((3, 3, 4, 1)):
        size = int(rng.integers(360, 480))
        img = rng.integers(0, 256, (size, size + 20, channels), np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), 2).reshape(img.shape)
        cv2.imwrite(str(d / f"patch_{i}.png"), img)
    return str(d)


def _pair(bg: str):
    cfg = dict(bg_dir=bg)
    return (jsynth.TextLineSynthesizer(jsynth.SynthConfig(**cfg)),
            StrokeSynthesizer(tsynth.SynthConfig(**cfg)))


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    err = float(np.abs(got.astype(np.float64) - want).max())
    if err <= TOL:
        return
    levels = np.abs(np.round(got * 127.5) - np.round(want * 127.5))
    assert levels.max() <= 1 and (levels > 0).mean() <= LEVEL_SHARE, \
        (what, err)


def test_constants_match_jax():
    assert (tsynth.CHECK_NUM, tsynth.GT_H, tsynth.GT_W, tsynth.LQ_H,
            tsynth.LQ_W) == (jsynth.CHECK_NUM, jsynth.GT_H, jsynth.GT_W,
                             jsynth.LQ_H, jsynth.LQ_W)
    j, t = jsynth.TextLineSynthesizer(jsynth.SynthConfig()), \
        tsynth.TextLineSynthesizer(tsynth.SynthConfig())
    assert (t.latin, t.digits) == (j.latin, j.digits)


@pytest.mark.parametrize("background", ["flat", "png"])
@pytest.mark.parametrize("seed", range(6))
def test_sample_matches_jax(pinned, bg_dir, background, seed):
    jax_synth, port_synth = _pair(bg_dir if background == "png" else "")
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jax_synth.sample(rj)
    got = port_synth.sample(rt)
    assert rj.bit_generator.state == rt.bit_generator.state
    assert got["text"] == want["text"]
    for key in ("label", "boxinfo", "mask"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key in ("gt", "lq"):
        _assert_close(got[key], want[key], key)


@pytest.mark.parametrize("max_chars", [None, 4])
def test_batch_matches_jax(pinned, bg_dir, max_chars):
    jax_synth, port_synth = _pair(bg_dir)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    want = jax_synth.batch(2, rj, max_chars=max_chars)
    got = port_synth.batch(2, rt, max_chars=max_chars)
    assert rj.bit_generator.state == rt.bit_generator.state
    assert set(got) == set(want)
    slots = max_chars or 16
    assert got["labels"].shape == (2, slots)
    assert got["gt"].shape == (2, 128, 128 * slots, 3)
    for key in want:
        if key in ("gt", "lq"):
            _assert_close(got[key], want[key], key)
        else:
            np.testing.assert_array_equal(got[key], want[key], key)


def test_render_names_what_is_missing():
    synth = tsynth.TextLineSynthesizer(tsynth.SynthConfig(font_dir="fonts"))
    bg = synth.background(np.random.default_rng(0))
    assert bg.shape == (128, 2048, 3)
    with pytest.raises(NotImplementedError, match="font pack"):
        synth.sample(np.random.default_rng(0))


@pytest.fixture(scope="module")
def mixed_bg_dir(tmp_path_factory):
    """A PNG, a JPEG, a BMP and a file cv2 cannot read."""
    d = tmp_path_factory.mktemp("mixed_bg")
    rng = np.random.default_rng(8)
    for name in ("a.png", "b.jpg", "c.bmp"):
        img = rng.integers(0, 256, (400, 420, 3), np.uint8)
        cv2.imwrite(str(d / name), cv2.GaussianBlur(img, (0, 0), 2))
    (d / "notes.txt").write_text("not an image\n")
    return str(d)


def test_other_background_files_are_named_and_skipped(mixed_bg_dir):
    """Every file of ``bg_dir`` is a background, as in the JAX package
    (``marconet_tpu/data/synth.py:106-109``), whatever its format; the
    port used to keep only the PNGs, so on the same seed it drew from a
    shorter list."""
    jax_synth, port_synth = _pair(mixed_bg_dir)
    assert port_synth.bg_paths == jax_synth.bg_paths
    assert [p.rsplit("/", 1)[1] for p in port_synth.bg_paths] == \
        ["a.png", "b.jpg", "c.bmp", "notes.txt"]


@pytest.mark.parametrize("seed", range(12))
def test_background_matches_jax_on_any_format(pinned, mixed_bg_dir, seed):
    """The draw picks the same file on both sides (seeds 0-11 pick each of
    the four at least once); a JPEG or BMP is read as cv2 reads it, the
    unreadable file gives the flat fallback."""
    jax_synth, port_synth = _pair(mixed_bg_dir)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jax_synth.background(rj)
    got = port_synth.background(rt)
    assert rj.bit_generator.state == rt.bit_generator.state
    _assert_close(got, want, "background")


def test_failed_degradation_falls_back_to_clean(pinned, monkeypatch):
    """A degradation that raises leaves the clean line, on both sides,
    after the same draws."""
    def fail(*args, **kwargs):
        raise RuntimeError("tiny crop")

    for module in (jsynth, tsynth):
        monkeypatch.setattr(module, "real_esrgan_degradation", fail,
                            raising=False)
        monkeypatch.setattr(module, "bsrgan_degradation", fail,
                            raising=False)
    import marconet_tpu.data.degrade as jdegrade
    monkeypatch.setattr(jdegrade, "real_esrgan_degradation", fail)
    monkeypatch.setattr(jdegrade, "bsrgan_degradation", fail)
    jax_synth, port_synth = _pair("")
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want, got = jax_synth.sample(rj), port_synth.sample(rt)
        assert rj.bit_generator.state == rt.bit_generator.state
        _assert_close(got["lq"], want["lq"], "lq")
