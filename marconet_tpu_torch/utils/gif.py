"""Animated GIF writing in numpy, without imageio or PIL.

The JAX package's ``tools/test_w.py`` saves its 11 style blends as an
animated GIF through ``imageio.mimsave(..., "GIF", duration=0.1)``; the
card's machine has no imageio, so the port's ``test_w`` uses this writer.

:func:`write_gif` writes a GIF89a: a NETSCAPE2.0 application extension
with the loop count, then per frame a graphics-control extension with its
delay in hundredths of a second, an image descriptor with the frame's own
palette and the frame's LZW-coded indices. Each palette is adaptive, up
to 256 colours and no dithering: the frame's exact colours when it has
256 or fewer, else a median cut over its distinct colours (each split the
box with the largest squared error, along its channel of largest
variance, where the two halves' squared error is least), every pixel
mapped to its nearest palette colour.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

MAX_COLORS = 256
_MAX_CODE = 4096          # LZW codes are at most 12 bits


def _sse(colors: np.ndarray, weights: np.ndarray) -> float:
    mean = (weights[:, None] * colors).sum(0) / weights.sum()
    return float((weights[:, None] * (colors - mean) ** 2).sum())


def _split(colors: np.ndarray, weights: np.ndarray):
    """Split a box of colours along its channel of largest variance where
    the two halves' summed squared error is least."""
    mean = (weights[:, None] * colors).sum(0) / weights.sum()
    var = (weights[:, None] * (colors - mean) ** 2).sum(0)
    order = np.argsort(colors[:, int(np.argmax(var))], kind="stable")
    c, w = colors[order], weights[order]
    cw = np.cumsum(w)[:-1]
    s1 = np.cumsum(w[:, None] * c, axis=0)[:-1]
    s2 = np.cumsum(w[:, None] * c * c, axis=0)[:-1]
    t1, t2, tw = (w[:, None] * c).sum(0), (w[:, None] * c * c).sum(0), w.sum()
    left = (s2 - s1 ** 2 / cw[:, None]).sum(1)
    right = ((t2 - s2) - (t1 - s1) ** 2 / (tw - cw)[:, None]).sum(1)
    cut = int(np.argmin(left + right)) + 1
    return (c[:cut], w[:cut]), (c[cut:], w[cut:])


def quantize(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> a (n, 3) uint8 palette (n <= 256) and (H, W)
    uint8 indices into it."""
    packed = (rgb[..., 0].astype(np.int64) << 16) \
        | (rgb[..., 1].astype(np.int64) << 8) | rgb[..., 2]
    uniq, inverse, counts = np.unique(packed.reshape(-1), return_inverse=True,
                                      return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=1)
    if len(uniq) <= MAX_COLORS:
        return colors.astype(np.uint8), \
            inverse.reshape(rgb.shape[:2]).astype(np.uint8)
    boxes = [(colors.astype(np.float64), counts.astype(np.float64))]
    errors = [_sse(*boxes[0])]
    while len(boxes) < MAX_COLORS:
        i = int(np.argmax(errors))
        if errors[i] <= 0:
            break
        a, b = _split(*boxes.pop(i))
        errors.pop(i)
        boxes += [a, b]
        errors += [_sse(*a), _sse(*b)]
    palette = np.stack([(w[:, None] * c).sum(0) / w.sum()
                        for c, w in boxes])
    palette = np.clip(np.rint(palette), 0, 255)
    _, nearest = cKDTree(palette).query(colors)
    return palette.astype(np.uint8), \
        nearest[inverse].reshape(rgb.shape[:2]).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a string of palette indices, clear code
    first, a clear code whenever the 4096-entry table is full, EOI last;
    codes packed least significant bit first."""
    clear = 1 << min_code_size
    first = clear + 2
    codes, widths = [clear], [min_code_size + 1]
    table = {}
    next_code, width = first, min_code_size + 1
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < _MAX_CODE:
            table[key] = next_code
            next_code += 1
            if next_code - 1 == 1 << width:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            table.clear()
            next_code, width = first, min_code_size + 1
        prefix = k
    codes += [prefix, clear + 1]
    widths += [width, min(next_code.bit_length(), 12)]
    codes_a = np.asarray(codes, np.int64)
    widths_a = np.asarray(widths, np.int64)
    starts = np.cumsum(widths_a) - widths_a
    bits = np.zeros(int(widths_a.sum()) + 7, np.uint8)
    for b in range(12):
        sel = widths_a > b
        bits[starts[sel] + b] = (codes_a[sel] >> b) & 1
    return np.packbits(bits[:int(widths_a.sum())], bitorder="little") \
        .tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out.append(len(part))
        out += part
    return bytes(out) + b"\0"


def encode_gif(frames: Sequence[np.ndarray], delay_cs: int = 10,
               loop: int = 0) -> bytes:
    """The bytes of an animated GIF89a of (H, W, 3) uint8 RGB frames of
    one size: ``delay_cs`` hundredths of a second a frame, ``loop``
    repetitions (0: forever)."""
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) \
        + b"\0"
    for frame in frames:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.shape != (h, w, 3):
            raise ValueError(f"GIF frames must be ({h}, {w}, 3) uint8, got "
                             f"{frame.shape} {frame.dtype}")
        palette, idx = quantize(frame)
        bits = max(1, int(len(palette) - 1).bit_length())
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        # graphics control: leave the frame in place, no transparency
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\0\0"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1))
        out += table.tobytes()
        min_code_size = max(2, bits)
        out.append(min_code_size)
        out += _sub_blocks(lzw_encode(idx.tobytes(), min_code_size))
    return bytes(out + b"\x3b")


def write_gif(path: str, frames: Sequence[np.ndarray], delay_cs: int = 10,
              loop: int = 0) -> None:
    """Write :func:`encode_gif` of ``frames`` to ``path``."""
    data = encode_gif(frames, delay_cs, loop)
    with open(path, "wb") as f:
        f.write(data)
