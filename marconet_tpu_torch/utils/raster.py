"""Glyph outlines to 8-bit coverage bitmaps in numpy.

FreeType's smooth rasterizer on an unhinted outline: the font-unit points
are scaled to 26.6 pixels with ``FT_MulFix`` and shifted by the glyph's
``xMin - lsb`` as FreeType's TrueType loader shifts them; each quadratic
arc is cut into ``2 ** k`` chords, ``k`` the number of quarterings that
bring its deviation ``|p0 - 2 p1 + p2|`` to a quarter pixel (FreeType's
``gray_render_conic``); the chords fill with the nonzero winding rule and
exact-area anti-aliasing: every chord is cut at the pixel grid, each piece
adds its signed height to the pixel it crosses in proportion to the part
of the pixel right of it and the rest to the next pixel, and a running
sum along each row gives the coverage, whose magnitude (at most one) is
scaled to 0-255 as FreeType scales its cell areas.

The JAX package's PIL loads glyphs hinted (FreeType's TrueType bytecode
interpreter); this module draws the unhinted outline, so stems land up to
a pixel from PIL's and edge pixels differ. ``PERF.md`` records the gap.

A glyph's bitmap does not depend on where it is drawn: PIL rounds every
glyph origin to a whole pixel (``tests/test_torch_render.py`` pins it), so
:func:`glyph_bitmap` caches bitmaps by (face, size, glyph).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

# the deviation, in pixels, below which FreeType draws an arc as a chord
_FLAT = 0.25


class GlyphBitmap(NamedTuple):
    """Coverage (rows top down) and its place: the bitmap's top-left
    pixel is ``left`` px right of the glyph origin and ``top`` px above
    the baseline."""

    coverage: np.ndarray            # (h, w) uint8
    left: int
    top: int


def scaled_outline(face, gid: int, size: int):
    """(points (N, 2) float pixels, y up; on-curve; contour ends) of the
    glyph at ``size`` px as FreeType scales it: 26.6 integers."""
    pts, on, ends = face.outline(gid)
    if not len(pts):
        return np.zeros((0, 2)), on, ends
    shift = face.x_min(gid) - int(face.lsb[gid])
    units = pts - np.array([shift, 0])
    scale = face.scale(size)
    fixed = (np.abs(units) * scale + 0x8000) >> 16
    return np.where(units < 0, -fixed, fixed) / 64.0, on, ends


def _chords(pts: np.ndarray, on: np.ndarray, ends):
    """Lines (M, 2, 2) and arcs (K, 3, 2) of the closed contours."""
    lines, arcs = [], []
    first = 0
    for last in ends:
        p, o = pts[first:last + 1], on[first:last + 1]
        first = last + 1
        if not len(p):
            continue
        if o.any():
            k = int(np.argmax(o))
            p, o = np.roll(p, -k, axis=0), np.roll(o, -k)
            start = p[0]
            seq = zip(list(p[1:]) + [start], list(o[1:]) + [True])
        else:                            # all off-curve: start between two
            start = (p[-1] + p[0]) / 2
            seq = zip(list(p) + [start], [False] * len(p) + [True])
        cur, ctrl = start, None
        for q, q_on in seq:
            if q_on:
                if ctrl is None:
                    lines.append((cur, q))
                else:
                    arcs.append((cur, ctrl, q))
                cur, ctrl = q, None
            elif ctrl is None:
                ctrl = q
            else:
                mid = (ctrl + q) / 2
                arcs.append((cur, ctrl, mid))
                cur, ctrl = mid, q
    return (np.array(lines, np.float64).reshape(-1, 2, 2),
            np.array(arcs, np.float64).reshape(-1, 3, 2))


def _flatten(lines: np.ndarray, arcs: np.ndarray) -> np.ndarray:
    """All chords (M, 4) as x0, y0, x1, y1, the arcs cut as FreeType
    cuts them."""
    if not len(arcs):
        return lines.reshape(-1, 4)
    p0, p1, p2 = arcs[:, 0], arcs[:, 1], arcs[:, 2]
    dev = np.abs(p0 - 2 * p1 + p2).max(axis=1)
    # quarterings: dev / 4**k <= 1/4
    k = np.zeros(len(arcs), np.int64)
    d = dev.copy()
    while (d > _FLAT).any():
        more = d > _FLAT
        k += more
        d = np.where(more, d / 4, d)
    count = 1 << k
    idx = np.repeat(np.arange(len(arcs)), count)
    starts = np.cumsum(count) - count
    step = np.arange(len(idx)) - np.repeat(starts, count)
    t0 = (step / count[idx])[:, None]
    t1 = ((step + 1) / count[idx])[:, None]
    a, b, c = p0[idx], p1[idx], p2[idx]

    def at(t):
        return (1 - t) ** 2 * a + 2 * t * (1 - t) * b + t * t * c

    chords = np.concatenate([at(t0), at(t1)], axis=1)
    return np.concatenate([lines.reshape(-1, 4), chords])


def fill(segs: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nonzero-winding coverage (height, width) uint8 of the chords
    ``segs`` (x0, y0, x1, y1 in pixels, y down from the bitmap's top)."""
    segs = segs[segs[:, 1] != segs[:, 3]]
    acc = np.zeros(height * (width + 2))
    if len(segs):
        x0, y0, x1, y1 = segs.T
        # cut every chord where it crosses a pixel column or row
        cuts = [np.zeros(len(segs)), np.ones(len(segs))]
        owners = [np.arange(len(segs))] * 2
        for a0, a1 in ((x0, x1), (y0, y1)):
            lo = np.floor(np.minimum(a0, a1)) + 1
            n = np.maximum(np.ceil(np.maximum(a0, a1)) - lo, 0).astype(
                np.int64)
            seg = np.repeat(np.arange(len(segs)), n)
            j = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
            cuts.append((lo[seg] + j - a0[seg]) / (a1 - a0)[seg])
            owners.append(seg)
        t = np.concatenate(cuts)
        seg = np.concatenate(owners)
        order = np.lexsort((t, seg))
        t, seg = t[order], seg[order]
        same = seg[:-1] == seg[1:]
        ta, tb, s = t[:-1][same], t[1:][same], seg[:-1][same]
        dx, dy = x1 - x0, y1 - y0
        xa, ya = x0[s] + ta * dx[s], y0[s] + ta * dy[s]
        xb, yb = x0[s] + tb * dx[s], y0[s] + tb * dy[s]
        xm, ym = (xa + xb) / 2, (ya + yb) / 2
        col = np.floor(xm).astype(np.int64)
        row = np.clip(np.floor(ym).astype(np.int64), 0, height - 1)
        frac = xm - col
        h = yb - ya
        base = row * (width + 2) + col
        acc += np.bincount(base, h * (1 - frac), len(acc))
        acc += np.bincount(base + 1, h * frac, len(acc))
    cover = np.abs(np.cumsum(acc.reshape(height, width + 2), axis=1))
    return np.minimum(cover[:, :width] * 256, 255).astype(np.uint8)


@functools.lru_cache(maxsize=8192)
def glyph_bitmap(face, size: int, gid: int) -> GlyphBitmap:
    """The coverage bitmap of glyph ``gid`` of ``face`` at ``size`` px."""
    pts, on, ends = scaled_outline(face, gid, size)
    if not len(pts):
        return GlyphBitmap(np.zeros((0, 0), np.uint8), 0, 0)
    left = int(np.floor(pts[:, 0].min()))
    right = int(np.ceil(pts[:, 0].max()))
    bottom = int(np.floor(pts[:, 1].min()))
    top = int(np.ceil(pts[:, 1].max()))
    width, height = max(right - left, 1), max(top - bottom, 1)
    segs = _flatten(*_chords(pts, on, ends))
    # to bitmap coordinates: x from the left edge, y down from the top
    segs = np.stack([segs[:, 0] - left, top - segs[:, 1],
                     segs[:, 2] - left, top - segs[:, 3]], axis=1)
    coverage = fill(segs, width, height)
    coverage.flags.writeable = False        # shared through the cache
    return GlyphBitmap(coverage, left, top)
