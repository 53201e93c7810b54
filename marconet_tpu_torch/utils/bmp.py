"""BMP reading in numpy, equal to what the JAX package gets from cv2.

:func:`read_bmp` returns what ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` returns for an uncompressed BMP:
an (H, W, 3) uint8 RGB image, byte for byte. It follows OpenCV's
``BmpDecoder`` (``grfmt_bmp.cpp``):

* a BITMAPINFOHEADER or a later header (V2-V5, OS/2 2.x: any size of at
  least 36 bytes) or the 12-byte OS/2 1.x core header;
* 1-, 4- and 8-bit palettes (the header's colour count, else 2**bits
  entries; an index past the palette reads black, as cv2's zeroed
  palette gives);
* 16 bits as 5-5-5, or 5-6-5 when ``BI_BITFIELDS`` masks
  (read after the header, where cv2 reads them) say so; each field is
  shifted to the top of its byte, not scaled;
* 24 bits, and 32 bits with the fourth byte dropped (``IMREAD_COLOR``);
* bottom-up (positive height) and top-down rows, rows padded to 4 bytes.

RLE4 / RLE8 compression raises a ``ValueError`` that names the file;
what cv2 refuses too (other ``BI_BITFIELDS`` masks at 16 bits, other
depths or header sizes, a truncated file) raises :class:`CorruptImage`.
"""

from __future__ import annotations

import struct

import numpy as np

from marconet_tpu_torch.utils.png import CorruptImage

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x03E0, 0x001F)
_MASKS_565 = (0xF800, 0x07E0, 0x001F)


def read_bmp(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 RGB image from an uncompressed BMP file (see the
    module docstring for what is accepted)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_bmp(data, str(path))


def decode_bmp(data: bytes, name: str = "<BMP bytes>") -> np.ndarray:
    def fail(why: str):
        raise CorruptImage(f"{name}: {why}")

    if len(data) < 26 or not data.startswith(b"BM"):
        fail("not a BMP file")
    (offset, size) = struct.unpack("<iI", data[10:18])
    if size >= 36:
        width, height, _, bpp, compression = struct.unpack(
            "<iiHHI", data[18:34])
        (clr_used,) = struct.unpack("<I", data[46:50])
        entry = 4
    elif size == 12:
        width, height, _, bpp = struct.unpack("<hhHH", data[18:26])
        compression, clr_used, entry = BI_RGB, 0, 3
    else:
        fail(f"BMP header of {size} bytes is not supported")
    after_header = 14 + size
    if compression in (BI_RLE4, BI_RLE8):
        raise ValueError(f"{name}: RLE-compressed BMP is not supported")
    if width <= 0 or height == 0:
        fail(f"BMP of {width}x{height} pixels")
    depth = bpp
    if compression == BI_BITFIELDS and bpp == 16:
        masks = struct.unpack("<III", data[after_header:after_header + 12])
        red, green, blue = masks
        if (red, green, blue) == _MASKS_555:
            depth = 15
        elif (red, green, blue) != _MASKS_565:
            fail(f"16-bit BMP with masks {masks} is not supported")
    elif bpp == 16 and compression == BI_RGB:
        depth = 15
    elif not (compression == BI_RGB and bpp in (1, 4, 8, 24, 32)
              or compression == BI_BITFIELDS and bpp == 32):
        fail(f"{bpp}-bit BMP with compression {compression} is not "
             "supported")

    palette = None
    if bpp <= 8:
        n = clr_used or (1 << bpp)
        if n > 256:
            fail("BMP palette of more than 256 colours")
        raw = data[after_header:after_header + n * entry]
        if len(raw) != n * entry:
            fail("truncated BMP palette")
        palette = np.zeros((256, 3), np.uint8)          # BGR, zero-filled
        palette[:n] = np.frombuffer(raw, np.uint8).reshape(n, entry)[:, :3]

    top_down = height < 0
    height = abs(height)
    pitch = ((width * (16 if depth == 15 else bpp) + 7) // 8 + 3) & -4
    pixels = data[offset:offset + pitch * height]
    if offset < 0 or len(pixels) != pitch * height:
        fail("truncated BMP pixel data")
    rows = np.frombuffer(pixels, np.uint8).reshape(height, pitch)
    if not top_down:
        rows = rows[::-1]

    if bpp <= 8:
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        idx = ((rows[:, :, None] >> shifts) & np.uint8((1 << bpp) - 1)) \
            .reshape(height, -1)[:, :width]
        bgr = palette[idx]
    elif bpp == 16:
        t = rows[:, :2 * width].reshape(height, width, 2).astype(np.uint16)
        t = t[..., 0] | (t[..., 1] << 8)
        if depth == 15:
            bgr = np.stack([t << 3, (t >> 2) & 0xF8, (t >> 7) & 0xF8],
                           axis=-1)
        else:
            bgr = np.stack([t << 3, (t >> 3) & 0xFC, (t >> 8) & 0xF8],
                           axis=-1)
        bgr = (bgr & 0xFF).astype(np.uint8)
    else:
        nch = bpp // 8
        bgr = rows[:, :nch * width].reshape(height, width, nch)[..., :3]
    return np.ascontiguousarray(bgr[..., ::-1])
