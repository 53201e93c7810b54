"""The port's BMP reader (``marconet_tpu_torch.utils.bmp``) against cv2.

``read_bmp`` must return ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``, byte for byte (tolerance: none),
on the files PIL writes in its modes ``1``, ``P``, ``L``, ``RGB`` and
``RGBA``, on cv2's own 24-bit and gray BMPs and on headers built here
that neither writes (top-down rows, 16 bits as 5-6-5 and 5-5-5, 32 bits
with ``BI_BITFIELDS``, a V4 header). What cv2 refuses too raises
``CorruptImage``; RLE compression, which cv2 reads, raises a plain
``ValueError``; both name the file. Images are made with numpy from a
seed.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from marconet_tpu_torch.utils.bmp import read_bmp
from marconet_tpu_torch.utils.png import CorruptImage

SIZES = [(1, 1), (7, 13), (37, 101)]


def _cv2_rgb(path):
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _check(path, data: bytes) -> None:
    path.write_bytes(data)
    want = _cv2_rgb(path)
    assert want is not None
    got = read_bmp(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["1", "P", "L", "RGB", "RGBA"])
def test_pil_modes(tmp_path, mode):
    """1-bit and 8-bit palettes, 8-bit gray, 24 and 32 bits (alpha
    dropped), at odd widths (row padding)."""
    for i, (h, w) in enumerate(SIZES):
        rgba = np.random.default_rng(i).integers(0, 256, (h, w, 4),
                                                 dtype=np.uint8)
        b = io.BytesIO()
        Image.fromarray(rgba, "RGBA").convert(mode).save(b, "BMP")
        _check(tmp_path / f"{mode}_{h}x{w}.bmp", b.getvalue())


@pytest.mark.parametrize("channels", [3, 1])
def test_cv2_writes(tmp_path, channels):
    for i, (h, w) in enumerate(SIZES):
        img = np.random.default_rng(10 + i).integers(0, 256, (h, w, 3),
                                                     dtype=np.uint8)
        img = img if channels == 3 else img[..., 0]
        _check(tmp_path / f"cv2_{h}x{w}.bmp",
               cv2.imencode(".bmp", img)[1].tobytes())


def _bmp(w: int, h: int, bpp: int, compression: int, rows, extra=b"",
         header: int = 40, top_down: bool = False, palette=b"") -> bytes:
    """A BMP file around ``rows`` (top row first), padded to 4 bytes."""
    pitch = ((w * bpp + 7) // 8 + 3) & -4
    order = rows if top_down else rows[::-1]
    pixels = b"".join(r.ljust(pitch, b"\0") for r in order)
    offset = 14 + header + len(extra) + len(palette)
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                       bpp, compression, len(pixels), 0, 0, 0, 0)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + b"\0" * (header - 40) + extra + palette + pixels)


MASKS_565 = struct.pack("<III", 0xF800, 0x07E0, 0x001F)
MASKS_555 = struct.pack("<III", 0x7C00, 0x03E0, 0x001F)


@pytest.mark.parametrize("case", ["565", "565_top_down", "555_bitfields",
                                  "555", "24_top_down", "32_bitfields",
                                  "24_v4_header", "4bit_palette"])
def test_hand_built_headers(tmp_path, case):
    rng = np.random.default_rng(len(case))
    w, h = 7, 5
    words = rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)
    rows16 = [words[y].astype("<u2").tobytes() for y in range(h)]

    def raw(nbytes):
        return [rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
                for _ in range(h)]

    data = {
        "565": _bmp(w, h, 16, 3, rows16, MASKS_565),
        "565_top_down": _bmp(w, h, 16, 3, rows16, MASKS_565, top_down=True),
        "555_bitfields": _bmp(w, h, 16, 3, rows16, MASKS_555),
        "555": _bmp(w, h, 16, 0, rows16),
        "24_top_down": _bmp(w, h, 24, 0, raw(3 * w), top_down=True),
        "32_bitfields": _bmp(w, h, 32, 3, raw(4 * w), struct.pack(
            "<III", 0xFF0000, 0xFF00, 0xFF)),
        "24_v4_header": _bmp(w, h, 24, 0, raw(3 * w), header=108),
        "4bit_palette": _bmp(w, h, 4, 0, raw((w + 1) // 2),
                             palette=rng.integers(0, 256, 64, dtype=np.uint8)
                             .tobytes()),
    }[case]
    _check(tmp_path / f"{case}.bmp", data)


def test_refusals_name_the_file(tmp_path):
    """RLE (cv2 reads it) raises ``ValueError``; masks cv2 does not take
    (a V5 header's, which cv2 looks for after the header), a truncated
    file and a text file raise ``CorruptImage``, where cv2 gives None."""
    w, h = 4, 2
    rows = [bytes(range(2 * w))] * h
    cases = {"rle8.bmp": (_bmp(w, h, 8, 1, [bytes(w)] * h,
                               palette=bytes(1024)), ValueError, "RLE"),
             "v5_565.bmp": (_bmp(w, h, 16, 3, rows, header=124),
                            CorruptImage, "masks"),
             "cut.bmp": (_bmp(w, h, 24, 0, [bytes(3 * w)] * h)[:-5],
                         CorruptImage, "truncated"),
             "notes.bmp": (b"BMnot an image at all\n", CorruptImage,
                           "not a BMP")}
    for name, (data, kind, why) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        if kind is CorruptImage:
            assert cv2.imread(str(path)) is None, name
        with pytest.raises(kind) as err:
            read_bmp(str(path))
        assert str(path) in str(err.value) and why in str(err.value), \
            (name, str(err.value))
