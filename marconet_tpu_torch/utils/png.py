"""PNG reading and writing in numpy and ``zlib``, without cv2 or PIL.

The CLIs of the JAX package read and write images through cv2
(``tools/test_sr.py``, ``tools/test_w.py``, ``tools/serve_demo.py``); the
card's machine has neither cv2 nor PIL, so the port's CLIs use this codec.

:func:`read_png` returns what ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` returns for the PNGs it accepts:
an (H, W, 3) uint8 RGB image, with alpha dropped (not blended), gray
replicated into three channels and palettes expanded. It accepts 8-bit
gray, gray + alpha, RGB and RGBA, and gray or palette images of 1, 2, 4
or 8 bits, non-interlaced, with any of the five row filters and the image
data split over any number of IDAT chunks; every chunk's CRC is checked.
Anything else (16 bits, interlacing, another format) raises a
``ValueError`` that names the file.

:func:`write_png` writes an (H, W, 3) uint8 RGB image as an 8-bit RGB PNG
in one IDAT chunk, every row unfiltered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8,)), 6: (4, (8,))}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: PNG without IEND")


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


def _unfilter(stream: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Filtered scanlines -> (height, stride) raw bytes."""
    if len(stream) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = np.frombuffer(stream, np.uint8)[:height * (stride + 1)] \
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
            raise ValueError(f"{path}: unknown PNG filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int
            ) -> np.ndarray:
    """(H, stride) bytes -> (H, W, channels) samples (uint8); depths
    below 8 bits come with one channel only."""
    h = rows.shape[0]
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
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, compression, filt, interlace = header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"{path}: PNG of {depth} bits, colour type "
                         f"{color} is not supported (8-bit gray, gray + "
                         "alpha, RGB, RGBA; gray or palette of 1-8 bits)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter "
                         "method")
    channels = _COLOR_TYPES[color][0]
    bits = width * channels * depth
    stride, bpp = (bits + 7) // 8, max(1, channels * depth // 8)
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    samples = _unpack(_unfilter(stream, height, stride, bpp, path), width,
                      channels, depth)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = samples[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
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
