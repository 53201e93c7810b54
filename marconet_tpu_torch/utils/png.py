"""PNG reading and writing in numpy and ``zlib``, without cv2 or PIL.

The CLIs of the JAX package read and write images through cv2
(``tools/test_sr.py``, ``tools/test_w.py``, ``tools/serve_demo.py``); the
card's machine has neither cv2 nor PIL, so the port's CLIs use this codec.

:func:`read_png` returns what ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` returns: an (H, W, 3) uint8 RGB
image, with alpha dropped (not blended), gray replicated into three
channels and palettes expanded. It accepts every PNG colour type at every
bit depth (gray of 1, 2, 4, 8 or 16 bits, palettes of 1-8 bits, RGB, gray
+ alpha and RGBA of 8 or 16 bits), 16-bit samples reduced to their high
byte as cv2 reduces them (libpng's ``png_set_strip_16``), non-interlaced
or Adam7-interlaced, with any of the five row filters and the image data
split over any number of IDAT chunks; every critical chunk's CRC is
checked (an ancillary chunk with a bad one is dropped, as libpng drops
it). A file that is no PNG, or a corrupt one, raises
:class:`CorruptImage`, a ``ValueError`` that names the file (cv2 returns
None for it).

:func:`write_png` writes an (H, W, 3) uint8 RGB image as an 8-bit RGB PNG
in one IDAT chunk, every row unfiltered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class CorruptImage(ValueError):
    """A file that is not a readable image of its format, which
    ``cv2.imread`` does not decode either (it returns None)."""


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise CorruptImage(f"{path}: truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise CorruptImage(f"{path}: truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) == crc:
            yield kind, payload
        elif kind[:1].isupper():
            # libpng's default: an error in a critical chunk; an ancillary
            # chunk with a bad CRC is dropped with a warning
            raise CorruptImage(f"{path}: bad CRC in PNG chunk {kind!r}")
        if kind == b"IEND":
            return
        pos = end + 4
    raise CorruptImage(f"{path}: PNG without IEND")


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one row (a byte-serial recurrence)."""
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(stream: bytes, start: int, height: int, stride: int,
              bpp: int, path: str) -> np.ndarray:
    """Filtered scanlines from ``stream[start:]`` -> (height, stride) raw
    bytes."""
    end = start + height * (stride + 1)
    if len(stream) < end:
        raise CorruptImage(f"{path}: PNG image data too short")
    rows = np.frombuffer(stream, np.uint8)[start:end] \
        .reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            row = raw
        elif kind == 1:      # Sub: a running sum in each of the bpp lanes
            lanes = raw.reshape(-1, bpp).astype(np.uint32)
            row = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8) \
                .reshape(-1)
        elif kind == 2:      # Up
            row = raw + prior
        elif kind == 3:
            row = _average_row(raw, prior, bpp)
        elif kind == 4:
            row = _paeth_row(raw, prior, bpp)
        else:
            raise CorruptImage(f"{path}: unknown PNG filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int
            ) -> np.ndarray:
    """(H, stride) bytes -> (H, W, channels) samples (uint8); 16-bit
    samples keep their high byte, depths below 8 bits come with one
    channel only."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * width * channels].reshape(
            h, width, channels, 2)[..., 0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(h, -1)[:, :width, None]


def read_png(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 RGB image from a PNG file (see the module
    docstring for what is accepted)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, str(path))


def decode_png(data: bytes, path: str = "<PNG bytes>") -> np.ndarray:
    """:func:`read_png` of a file's bytes; ``path`` names it in errors."""
    if not data.startswith(SIGNATURE):
        raise CorruptImage(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise CorruptImage(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, compression, filt, interlace = header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise CorruptImage(f"{path}: PNG of {depth} bits, colour type "
                           f"{color} is not a valid PNG")
    if compression != 0 or filt != 0 or interlace not in (0, 1):
        raise CorruptImage(f"{path}: unknown PNG compression, filter or "
                           "interlace method")
    channels = _COLOR_TYPES[color][0]
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"{path}: corrupt PNG image data ({e})") from e
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((height, width, channels if depth >= 8 else 1),
                       np.uint8)
    start, bpp = 0, max(1, channels * depth // 8)
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue                    # an empty pass has no scanlines
        stride = (w * channels * depth + 7) // 8
        rows = _unfilter(stream, start, h, stride, bpp, path)
        samples[y0::dy, x0::dx] = _unpack(rows, w, channels, depth)
        start += h * (stride + 1)
    if color == 3:
        if palette is None:
            raise CorruptImage(f"{path}: palette PNG without PLTE")
        idx = samples[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise CorruptImage(f"{path}: palette index out of range")
        return palette[idx]
    if color in (0, 4):
        gray = samples[..., :1]
        if depth < 8:            # scale 1/2/4-bit gray to 0..255
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray, 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB image as the bytes of an 8-bit RGB PNG."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # filter byte 0: none
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit RGB PNG."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
