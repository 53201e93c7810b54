"""The port's PNG codec (``marconet_tpu_torch.utils.png``) against cv2.

``read_png`` must return what the JAX CLIs get from
``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``,
byte for byte (tolerance: none). Files come from ``cv2.imencode`` (every
colour type, bit depth and row filter it can write, odd sizes) and from a
small encoder in this file for what cv2 does not write (palettes, 2- and
4-bit gray, gray + alpha, all five filters in one image, image data split
over several IDAT chunks); cv2 reads those too, so both are held to it.
16-bit samples (reduced to their high byte, as cv2 reduces them) and
Adam7 interlacing come from the same encoder. Images are made with numpy
from a seed.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from marconet_tpu_torch.utils import png

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}
SIZES = [(1, 1), (7, 13), (33, 101)]


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded image with smooth parts (so filters predict) and noise."""
    rng = np.random.default_rng(seed)
    ch = {"gray": 1, "bgr": 3, "bgra": 4, "bilevel": 1}[kind]
    ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256)
    img = np.repeat(ramp[:, :, None], ch, axis=2).astype(np.uint8)
    noise = rng.integers(0, 256, img.shape, dtype=np.uint8)
    img[: h // 2] = noise[: h // 2]
    if kind == "bilevel":
        img = np.where(img > 127, 255, 0).astype(np.uint8)
    return img[:, :, 0] if ch == 1 else img


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "bilevel"])
def test_read_matches_cv2(tmp_path, kind, filt):
    """Every colour type, bit depth (8, and 1 for bilevel) and filter
    choice ``cv2.imencode`` offers, at odd sizes."""
    for i, (h, w) in enumerate(SIZES):
        img = _image(kind, h, w, seed=i)
        params = [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]]
        if kind == "bilevel":
            params += [cv2.IMWRITE_PNG_BILEVEL, 1]
        ok, buf = cv2.imencode(".png", img, params)
        assert ok
        path = tmp_path / f"{kind}_{filt}_{h}x{w}.png"
        path.write_bytes(buf.tobytes())
        got = png.read_png(str(path))
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("h,w", SIZES + [(64, 1024)])
def test_write_round_trips_through_cv2(tmp_path, h, w):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    path = tmp_path / "out.png"
    png.write_png(str(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


# ---------------------------------------------------------------------------
# a small encoder for what cv2 does not write
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind: int, row: bytes, prior: bytes, bpp: int) -> bytes:
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((x - pred) % 256)
    return bytes(out)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _scanlines(samples: np.ndarray, depth: int) -> list:
    """(h, w, c) samples -> packed rows, most significant bits first."""
    rows = []
    for y in range(samples.shape[0]):
        bits = "".join(format(int(v), f"0{depth}b")
                       for v in samples[y].reshape(-1))
        bits += "0" * (-len(bits) % 8)
        rows.append(bytes(int(bits[i:i + 8], 2)
                          for i in range(0, len(bits), 8)))
    return rows


def _encode(samples: np.ndarray, depth: int, color: int, palette=None,
            idat_parts: int = 1, interlace: int = 0) -> bytes:
    """(H, W, C) samples -> PNG bytes; row y of each pass uses filter
    y % 5. ``interlace`` 1 writes the seven Adam7 passes (any other value
    is written into the header only)."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = png.ADAM7 if interlace == 1 else ((0, 0, 1, 1),)
    stream = bytearray()
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue                    # an empty pass has no scanlines
        rows = _scanlines(sub, depth)
        prior = bytes(len(rows[0]))
        for y, row in enumerate(rows):
            stream.append(y % 5)
            stream += _filter_row(y % 5, row, prior, bpp)
            prior = row
    data = zlib.compress(bytes(stream))
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    for a, b in zip(cut[:-1], cut[1:]):
        out += _chunk(b"IDAT", data[a:b])
    return out + _chunk(b"IEND", b"")


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette(tmp_path, depth):
    """Palette images of every bit depth: each index maps to its entry."""
    rng = np.random.default_rng(depth)
    n = 1 << depth
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    idx = rng.integers(0, n, (9, 23, 1), dtype=np.uint8)
    path = tmp_path / "pal.png"
    path.write_bytes(_encode(idx, depth, 3, palette, idat_parts=3))
    got = png.read_png(str(path))
    np.testing.assert_array_equal(got, palette[idx[..., 0]])
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_low_bit_gray(tmp_path, depth):
    """Gray of 1-8 bits scales to 0..255 by 255 / (2**depth - 1)."""
    rng = np.random.default_rng(10 + depth)
    g = rng.integers(0, 1 << depth, (11, 19, 1), dtype=np.uint8)
    path = tmp_path / "gray.png"
    path.write_bytes(_encode(g, depth, 0, idat_parts=2))
    got = png.read_png(str(path))
    want = np.repeat(g * (255 // ((1 << depth) - 1)), 3, axis=2)
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("color,channels", [(4, 2), (6, 4), (2, 3)])
def test_alpha_dropped_and_all_filters(tmp_path, color, channels):
    """Gray + alpha, RGBA and RGB with rows cycling through all five
    filters over four IDAT chunks: alpha is dropped, not blended."""
    rng = np.random.default_rng(color)
    s = rng.integers(0, 256, (12, 17, channels), dtype=np.uint8)
    path = tmp_path / "alpha.png"
    path.write_bytes(_encode(s, 8, color, idat_parts=4))
    got = png.read_png(str(path))
    want = np.repeat(s[..., :1], 3, axis=2) if channels == 2 else s[..., :3]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_refusals_name_the_file(tmp_path):
    """Bad CRC, an unknown interlace method, a bit depth its colour type
    does not allow, a JPEG, a text file and a truncated PNG each raise a
    ValueError naming the file (``CorruptImage``: cv2 reads none of
    them as a PNG)."""
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8)
    good = _encode(img, 8, 2)
    idat = good.index(b"IDAT") + 4            # first byte of its payload
    cases = {"crc.png": (good[:idat] + bytes([good[idat] ^ 1])
                         + good[idat + 1:], "bad CRC"),
             "interlaced.png": (_encode(img, 8, 2, interlace=2),
                                "interlace method"),
             "deep.png": (_encode(img[..., :1], 16, 3), "16 bits"),
             "photo.jpg": (cv2.imencode(".jpg", img)[1].tobytes(),
                           "not a PNG"),
             "notes.png": (b"not an image\n", "not a PNG"),
             "cut.png": (good[:len(good) // 2], "truncated")}
    for name, (data, why) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        if name != "photo.jpg":            # a JPEG, which cv2 reads
            assert cv2.imread(str(path)) is None, name
        with pytest.raises(png.CorruptImage) as err:
            png.read_png(str(path))
        assert str(path) in str(err.value) and why in str(err.value), \
            (name, str(err.value))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "f.png"), img.astype(np.float32))


# ---------------------------------------------------------------------------
# 16-bit samples and Adam7 interlacing
# ---------------------------------------------------------------------------

SIXTEEN = {"gray": (0, 1), "rgb": (2, 3), "gray_alpha": (4, 2),
           "rgba": (6, 4)}


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("kind", list(SIXTEEN))
def test_16_bit(tmp_path, kind, interlace):
    """16-bit samples keep their high byte, as cv2's IMREAD_COLOR reads
    them (libpng's ``png_set_strip_16``), plain and Adam7."""
    color, channels = SIXTEEN[kind]
    for i, (h, w) in enumerate(SIZES):
        s = np.random.default_rng(20 + i).integers(
            0, 1 << 16, (h, w, channels), dtype=np.uint16)
        path = tmp_path / f"{kind}_{h}x{w}.png"
        path.write_bytes(_encode(s, 16, color, interlace=interlace))
        got = png.read_png(str(path))
        high = (s >> 8).astype(np.uint8)
        want = np.repeat(high[..., :1], 3, axis=2) if channels < 3 \
            else high[..., :3]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("channels", [3, 1])
def test_16_bit_from_cv2(tmp_path, channels):
    img = np.random.default_rng(30).integers(0, 1 << 16, (9, 17, 3),
                                             dtype=np.uint16)
    img = img if channels == 3 else img[..., 0]
    path = tmp_path / "deep.png"
    path.write_bytes(cv2.imencode(".png", img)[1].tobytes())
    np.testing.assert_array_equal(png.read_png(str(path)), _cv2_rgb(path))


@pytest.mark.parametrize("case", ["rgb8", "rgba8", "gray1", "gray2",
                                  "palette4", "palette8", "gray_alpha8"])
def test_adam7(tmp_path, case):
    """Adam7 at sizes where some passes are empty (1 x 1, 2 x 3) and
    where all run, for every kind of 8-bit and low-bit sample."""
    depth, color, channels = {"rgb8": (8, 2, 3), "rgba8": (8, 6, 4),
                              "gray1": (1, 0, 1), "gray2": (2, 0, 1),
                              "palette4": (4, 3, 1), "palette8": (8, 3, 1),
                              "gray_alpha8": (8, 4, 2)}[case]
    rng = np.random.default_rng(len(case))
    palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8) \
        if color == 3 else None
    for h, w in [(1, 1), (2, 3), (17, 29)]:
        s = rng.integers(0, 1 << depth, (h, w, channels), dtype=np.uint8)
        path = tmp_path / f"{case}_{h}x{w}.png"
        path.write_bytes(_encode(s, depth, color, palette, idat_parts=2,
                                 interlace=1))
        got = png.read_png(str(path))
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(path))
