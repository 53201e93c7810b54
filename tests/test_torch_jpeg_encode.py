"""The port's libjpeg-exact JPEG encoding (``marconet_tpu_torch.utils.jpeg``:
``encode_coefficients``, ``jpeg_roundtrip_u8``) against cv2.

The JAX package's BSRGAN ``_add_jpeg`` and the paired degradations' JPEG
step round-trip through ``cv2.imencode`` / ``cv2.imdecode`` (libjpeg-turbo,
baseline 4:2:0, the standard tables scaled by quality). The port has no
cv2 on the card's machine, so it computes libjpeg-turbo's quantized
coefficients itself and sends them through its own decoder's output stage.
Tolerance everywhere: none.

* The coefficients and quantization tables equal those the port's decoder
  reads from cv2's bytes for the same image, over the whole MCU-padded
  block grid (the dummy blocks past the image's edge included).
* The round trip equals cv2's, byte for byte, at every quality 30-95 (the
  range the degradations draw), on seeded text lines and random images at
  widths and heights that are not multiples of 16, down to 1-3 pixels; and
  equals the port's own ``decode_jpeg`` of cv2's bytes.
* The quantizer's plain rounded division gives libjpeg-turbo's reciprocal
  multiply's quotients for every divisor and every value the DCT can give.

The fixtures under ``tests/data/jpeg/roundtrip/`` (two source PNGs and
cv2's encodes of each at qualities 30, 60 and 95; the card's smoke run
holds the round trip to their decodes, where there is no cv2) are held to
cv2 here, so a stale fixture fails. ``python -m tests.test_torch_jpeg_encode``
writes them anew.
"""

import os

import cv2
import numpy as np
import pytest

from marconet_tpu_torch.utils import jpeg
from marconet_tpu_torch.utils.png import read_png
from tests.test_torch_jpeg import FIXTURES, _image, _line

SHAPES = [(32, 512), (37, 101), (1, 1), (2, 3), (17, 16)]
ROUNDTRIP_DIR = os.path.join(FIXTURES, "roundtrip")
ROUNDTRIP_SOURCES = {"line_37x203": lambda: _line(37, 203, 5),
                     "noise_37x203": lambda: _image(37, 203, 5)}
ROUNDTRIP_QUALITIES = (30, 60, 95)


def _cv2_bytes(rgb: np.ndarray, quality: int) -> bytes:
    """What the JAX package's JPEG steps encode: RGB -> BGR -> imencode."""
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    assert ok
    return buf.tobytes()


def _cv2_roundtrip(rgb: np.ndarray, quality: int) -> np.ndarray:
    dec = cv2.imdecode(np.frombuffer(_cv2_bytes(rgb, quality), np.uint8),
                       cv2.IMREAD_COLOR)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB)


def _random(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("quality", [30, 50, 75, 85, 95])
def test_coefficients_equal_cv2s(quality, shape):
    """Y 2 x 2, Cb and Cr 1 x 1: each component's coefficients (every
    block of its MCU grid) and its table, as stored in cv2's file."""
    for i, img in enumerate((_image(*shape, quality),
                             _random(*shape, quality))):
        data = _cv2_bytes(img, quality)
        want_coefs, want_quants = jpeg.jpeg_coefficients(data)
        got_coefs, got_quants = jpeg.encode_coefficients(img, quality)
        assert len(got_coefs) == len(want_coefs) == 3
        for c, (got, want) in enumerate(zip(got_coefs, want_coefs)):
            assert got.shape == want.shape, (i, c)
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {c}")
        for got, want in zip(got_quants, want_quants):
            np.testing.assert_array_equal(got, want)


def test_quant_tables_equal_cv2s():
    """``jpeg_set_quality``'s tables at every quality 1-100 (the DQT of
    cv2's files)."""
    img = _random(8, 8, 0)
    for quality in range(1, 101):
        _, want = jpeg.jpeg_coefficients(_cv2_bytes(img, quality))
        luma, chroma = jpeg.quant_tables(quality)
        np.testing.assert_array_equal(luma, want[0], err_msg=str(quality))
        np.testing.assert_array_equal(chroma, want[1], err_msg=str(quality))


@pytest.mark.parametrize("quality", range(30, 96))
def test_roundtrip_equals_cv2s(quality):
    """Byte for byte: a text line, a noisy gradient and random images at
    odd sizes, the smallest 1-3 pixels."""
    images = [_line(32, 200 + quality, quality), _image(37, 53, quality),
              _random(17, 31, quality), _random(1 + quality % 3,
                                                1 + quality % 2, quality)]
    for img in images:
        got = jpeg.jpeg_roundtrip_u8(img, quality)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, _cv2_roundtrip(img, quality),
                                      err_msg=str(img.shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_roundtrip_equals_decode_of_cv2s_bytes(shape):
    for quality in (30, 60, 95):
        img = _image(*shape, 100 + quality)
        np.testing.assert_array_equal(
            jpeg.jpeg_roundtrip_u8(img, quality),
            jpeg.decode_jpeg(_cv2_bytes(img, quality)))


def _reciprocal(divisor: int):
    """``jcdctmgr.c::compute_reciprocal`` with 16-bit ``DCTELEM`` (the
    SIMD build): (reciprocal, correction, shift)."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def test_quantize_is_libjpeg_turbos_reciprocal_multiply():
    """Every divisor ``q << 3`` (q 1-255) and every |coefficient| up to
    the DCT's largest (8192, a flat block of 0 or 255)."""
    flat = np.full((2, 8, 8), 255, np.uint8)
    flat[0] = 0
    top = int(np.abs(jpeg.fdct_islow(flat)).max())
    assert top == 8192
    x = np.arange(-top, top + 1, dtype=np.int64)
    for q in range(1, 256):
        fq, c, r = _reciprocal(q << 3)
        want = ((np.abs(x) + c) * fq) >> r
        want = np.where(x < 0, -want, want)
        got = jpeg.quantize(x, np.int64(q))
        np.testing.assert_array_equal(got, want, err_msg=str(q))


def test_rejects_other_than_rgb_uint8():
    with pytest.raises(ValueError):
        jpeg.encode_coefficients(np.zeros((4, 4), np.uint8), 50)
    with pytest.raises(ValueError):
        jpeg.jpeg_roundtrip_u8(np.zeros((4, 4, 3), np.float32), 50)


# ---------------------------------------------------------------------------
# the committed round-trip fixtures
# ---------------------------------------------------------------------------

def write_roundtrip_fixtures(d: str = ROUNDTRIP_DIR) -> None:
    """Each source as ``<name>.png`` and cv2's encode of it at every
    quality of ``ROUNDTRIP_QUALITIES`` as ``<name>_q<quality>.jpg``."""
    os.makedirs(d, exist_ok=True)
    for name, make in ROUNDTRIP_SOURCES.items():
        rgb = make()
        cv2.imwrite(os.path.join(d, name + ".png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
        for quality in ROUNDTRIP_QUALITIES:
            with open(os.path.join(d, f"{name}_q{quality}.jpg"), "wb") as f:
                f.write(_cv2_bytes(rgb, quality))


@pytest.mark.parametrize("name", list(ROUNDTRIP_SOURCES))
def test_roundtrip_fixtures_are_cv2s(name):
    """The committed source is the seeded image, each JPEG is cv2's encode
    of it, and the round trip decodes as the port's decoder decodes it."""
    src = read_png(os.path.join(ROUNDTRIP_DIR, name + ".png"))
    np.testing.assert_array_equal(src, ROUNDTRIP_SOURCES[name]())
    for quality in ROUNDTRIP_QUALITIES:
        with open(os.path.join(ROUNDTRIP_DIR, f"{name}_q{quality}.jpg"),
                  "rb") as f:
            data = f.read()
        assert data == _cv2_bytes(src, quality)
        np.testing.assert_array_equal(jpeg.jpeg_roundtrip_u8(src, quality),
                                      jpeg.decode_jpeg(data))


def test_roundtrip_fixtures_are_small():
    names = sorted(os.listdir(ROUNDTRIP_DIR))
    assert len(names) == len(ROUNDTRIP_SOURCES) * (
        1 + len(ROUNDTRIP_QUALITIES)), names
    total = sum(os.path.getsize(os.path.join(ROUNDTRIP_DIR, n))
                for n in names)
    assert total <= 50_000, total


if __name__ == "__main__":
    write_roundtrip_fixtures()
