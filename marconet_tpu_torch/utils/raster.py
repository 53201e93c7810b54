"""Glyph outlines to 8-bit coverage bitmaps in numpy, equal to FreeType's
smooth rasterizer (``ftgrays.c``, FreeType 2.14) bit for bit.

The outline is the hinted one (``utils/ttinterp.py``): 26.6 integer
points, y up. Every step keeps FreeType's integers:

* the bitmap's box is the control box floored and ceiled to whole pixels
  (``ft_glyph_slot_preset_bitmap``) and the outline is moved to it;
* each contour is cut into lines and quadratic arcs as
  ``FT_Outline_Decompose`` cuts it, the midpoint of two off-curve points
  an integer halving in 26.6;
* points go to 1/256 px (``UPSCALE``); an arc is drawn as ``2 ** k``
  chords, ``k`` the quarterings that bring ``max |p0 - 2 p1 + p2|`` to a
  quarter pixel, whose ends are the arc's exact points floored to 1/256 px
  (``gray_render_conic``'s forward differences in 32.32 are exact);
* each chord walks the cells it crosses (``gray_render_line``): where it
  leaves a cell through an edge, the place on that edge is the exact
  quotient computed as FreeType computes it, by a reciprocal multiply
  that may fall one below (``FT_UDIV``); a cell gathers ``cover`` (the
  sum of the pieces' heights) and ``area`` (their heights times twice
  their mean x);
* a row's running cover and each cell's area give the coverage
  (``gray_sweep``): ``a >> 9`` for ``a >= 0`` and ``~(a >> 9)`` below,
  capped at 255.

A glyph's bitmap does not depend on where it is drawn: PIL rounds every
glyph origin to a whole pixel (``tests/test_torch_render.py`` pins it), so
:func:`glyph_bitmap` caches bitmaps by (face, size, glyph).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

ONE_PIXEL = 256                     # subpixels a pixel (PIXEL_BITS = 8)
_UDIV_ONE = 0xFFFFFFFF               # FT_UDIVPREP's dividend


class GlyphBitmap(NamedTuple):
    """Coverage (rows top down) and its place: the bitmap's top-left
    pixel is ``left`` px right of the glyph origin and ``top`` px above
    the baseline."""

    coverage: np.ndarray            # (h, w) uint8
    left: int
    top: int


def _decompose(pts: np.ndarray, on: np.ndarray, ends):
    """Lines (M, 2, 2) and arcs (K, 3, 2) of the closed contours, int64
    26.6, as ``FT_Outline_Decompose`` emits them (``pts`` non-negative, so
    its halving is a floor)."""
    lines, arcs = [], []
    first = 0
    for last in ends:
        p = [tuple(v) for v in pts[first:last + 1].tolist()]
        o = on[first:last + 1].tolist()
        first = last + 1
        if not p:
            continue
        if o[0]:
            start, rest, rest_on = p[0], p[1:], o[1:]
        elif o[-1]:                              # start at the last point
            start, rest, rest_on = p[-1], p[:-1], o[:-1]
        else:                                    # between last and first
            start = ((p[0][0] + p[-1][0]) >> 1, (p[0][1] + p[-1][1]) >> 1)
            rest, rest_on = p, o
        cur, ctrl = start, None
        for q, q_on in zip(rest, rest_on):
            if q_on:
                if ctrl is None:
                    lines.append((cur, q))
                else:
                    arcs.append((cur, ctrl, q))
                cur, ctrl = q, None
            elif ctrl is None:
                ctrl = q
            else:
                mid = ((ctrl[0] + q[0]) >> 1, (ctrl[1] + q[1]) >> 1)
                arcs.append((cur, ctrl, mid))
                cur, ctrl = mid, q
        if ctrl is None:
            lines.append((cur, start))
        else:
            arcs.append((cur, ctrl, start))
    return (np.array(lines, np.int64).reshape(-1, 2, 2),
            np.array(arcs, np.int64).reshape(-1, 3, 2))


def _chords(lines: np.ndarray, arcs: np.ndarray) -> np.ndarray:
    """All chords (M, 4) as x0, y0, x1, y1 in 1/256 px: the lines and the
    arcs cut as ``gray_render_conic`` cuts them."""
    lines = lines.reshape(-1, 4) * 4
    if not len(arcs):
        return lines
    p0, p1, p2 = arcs[:, 0] * 4, arcs[:, 1] * 4, arcs[:, 2] * 4
    a = p0 + p2 - 2 * p1
    b = p1 - p0
    dev = np.abs(a).max(axis=1)
    shift = np.zeros(len(arcs), np.int64)
    more = dev > ONE_PIXEL // 4
    while more.any():
        dev = np.where(more, dev >> 2, dev)
        shift += more
        more = dev > ONE_PIXEL // 4
    count = 1 << shift
    idx = np.repeat(np.arange(len(arcs)), count)
    starts = np.cumsum(count) - count
    k = np.arange(len(idx)) - np.repeat(starts, count) + 1
    n = count[idx][:, None]
    kk = k[:, None]
    # floor(P(k / n)) with P(t) = p0 + 2 b t + a t^2, in integers
    ends = (p0[idx] * n * n + 2 * b[idx] * kk * n
            + a[idx] * kk * kk) // (n * n)
    begins = np.empty_like(ends)
    begins[1:] = ends[:-1]
    begins[starts] = p0
    return np.concatenate([lines, np.concatenate([begins, ends], axis=1)])


def _udiv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``FT_UDIV(a, b)``: ``a * (0xFFFFFFFF // b) >> 32`` in 64-bit
    unsigned arithmetic, for ``0 <= a <= 256 b``: the quotient, or one
    below it."""
    recip = (_UDIV_ONE // np.maximum(b, 1)).astype(np.uint64)
    return ((a.astype(np.uint64) * recip) >> np.uint64(32)).astype(np.int64)


def _cells(segs: np.ndarray, width: int, height: int):
    """(cover, area), each (height, width) int64, of the chords ``segs``
    (x0, y0, x1, y1 in 1/256 px, y up from the bitmap's bottom), walked
    as ``gray_render_line`` walks them."""
    cover = np.zeros(height * width, np.int64)
    area = np.zeros(height * width, np.int64)
    x0, y0, x1, y1 = segs.T
    ey1, ey2 = y0 >> 8, y1 >> 8
    keep = (y0 != y1) & ~(((ey1 >= height) & (ey2 >= height)) |
                          ((ey1 < 0) & (ey2 < 0)))
    x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
    if not len(x0):
        return cover.reshape(height, width), area.reshape(height, width)
    ex1, ex2, ey1, ey2 = x0 >> 8, x1 >> 8, y0 >> 8, y1 >> 8
    dx, dy = x1 - x0, y1 - y0
    n_seg = len(x0)
    nx, ny = np.abs(ex2 - ex1), np.abs(ey2 - ey1)
    # the grid lines each chord crosses, in walking order
    seg_x = np.repeat(np.arange(n_seg), nx)
    jx = np.arange(nx.sum()) - np.repeat(np.cumsum(nx) - nx, nx)
    gx = np.where(dx[seg_x] > 0, ex1[seg_x] + 1 + jx, ex1[seg_x] - jx) * 256
    seg_y = np.repeat(np.arange(n_seg), ny)
    jy = np.arange(ny.sum()) - np.repeat(np.cumsum(ny) - ny, ny)
    gy = np.where(dy[seg_y] > 0, ey1[seg_y] + 1 + jy, ey1[seg_y] - jy) * 256
    seg = np.concatenate([seg_x, seg_y])
    is_x = np.concatenate([np.ones(len(seg_x), bool),
                           np.zeros(len(seg_y), bool)])
    # t along the chord times |dx| |dy|; at a corner the x move comes
    # first except on a chord going up and left
    key = np.concatenate([np.abs(gx - x0[seg_x]) * np.abs(dy[seg_x]),
                          np.abs(gy - y0[seg_y]) * np.abs(dx[seg_y])])
    y_first = (dx[seg] < 0) & (dy[seg] > 0)
    tie = np.where(is_x, y_first, ~y_first)
    j = np.concatenate([jx, jy])
    order = np.lexsort((j, tie, key, seg))
    seg, is_x, j = seg[order], is_x[order], j[order]
    m = nx + ny
    first = np.cumsum(m) - m
    # the cell before each crossing: the moves made before it
    xs = is_x.astype(np.int64)
    before = np.cumsum(xs) - xs
    cum_x = before - before[first[seg]]
    cum_y = np.arange(len(seg)) - first[seg] - cum_x
    sx, sy = np.sign(dx[seg]), np.sign(dy[seg])
    cx = ex1[seg] + sx * cum_x
    cy = ey1[seg] + sy * cum_y
    sdx, sdy = dx[seg], dy[seg]
    prod = sdx * (y0[seg] - 256 * cy) - sdy * (x0[seg] - 256 * cx)
    # the crossing's place on its edge (local 0..256)
    num = np.where(is_x, np.where(sdx > 0, prod + 256 * sdy, -prod),
                   np.where(sdy > 0, 256 * sdx - prod, prod))
    den = np.where(is_x, np.abs(sdx), np.abs(sdy))
    v = _udiv(num, den)
    vertical = ~is_x & (sdx == 0)
    v = np.where(vertical, (x0[seg] & 255), v)
    exit_x = np.where(is_x, np.where(sdx > 0, 256, 0), v)
    exit_y = np.where(is_x, v, np.where(sdy > 0, 256, 0))
    entry_x = np.where(is_x, 256 - exit_x, exit_x)
    entry_y = np.where(is_x, exit_y, 256 - exit_y)
    # pieces: segment i has m_i + 1, the k-th ending at crossing k
    n_piece = m + 1
    p_first = np.cumsum(n_piece) - n_piece
    total = int(n_piece.sum())
    fx_a = np.empty(total, np.int64)
    fy_a = np.empty(total, np.int64)
    fx_b = np.empty(total, np.int64)
    fy_b = np.empty(total, np.int64)
    pcx = np.empty(total, np.int64)
    pcy = np.empty(total, np.int64)
    at = p_first[seg] + (np.arange(len(seg)) - first[seg])
    fx_b[at], fy_b[at], pcx[at], pcy[at] = exit_x, exit_y, cx, cy
    fx_a[at + 1], fy_a[at + 1] = entry_x, entry_y
    fx_a[p_first], fy_a[p_first] = x0 & 255, y0 & 255
    last = p_first + m
    fx_b[last], fy_b[last] = x1 & 255, y1 & 255
    pcx[last], pcy[last] = ex2, ey2
    h = fy_b - fy_a
    ok = (pcx >= 0) & (pcx < width) & (pcy >= 0) & (pcy < height)
    cell = (pcy * width + pcx)[ok]
    cover += np.bincount(cell, h[ok], height * width).astype(np.int64)
    area += np.bincount(cell, (h * (fx_a + fx_b))[ok],
                        height * width).astype(np.int64)
    return cover.reshape(height, width), area.reshape(height, width)


def _sweep(cover: np.ndarray, area: np.ndarray) -> np.ndarray:
    """``gray_sweep`` with the nonzero rule: coverage (rows bottom up)."""
    a = np.cumsum(cover * (2 * ONE_PIXEL), axis=1) - area
    c = a >> 9
    c = np.where(c < 0, ~c, c)
    return np.minimum(c, 255).astype(np.uint8)


def fill(segs: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nonzero-winding coverage (height, width) uint8 of the chords
    ``segs`` (x0, y0, x1, y1 in pixels, y down from the bitmap's top; on
    FreeType's 1/256 px grid), as FreeType's smooth rasterizer fills
    them."""
    sub = np.rint(np.asarray(segs, np.float64) * ONE_PIXEL).astype(np.int64)
    up = np.stack([sub[:, 0], height * ONE_PIXEL - sub[:, 1],
                   sub[:, 2], height * ONE_PIXEL - sub[:, 3]], axis=1)
    cover, area = _cells(up.reshape(-1, 4), width, height)
    return _sweep(cover, area)[::-1]


def render(pts: np.ndarray, on: np.ndarray, ends,
           overlap: bool = False) -> GlyphBitmap:
    """The smooth rasterizer's bitmap of an outline: ``pts`` (N, 2)
    integer 26.6 pixels, y up; ``on`` its on-curve flags; ``ends`` the
    contours' last point indices. An ``overlap`` outline (a glyph flagged
    OVERLAP_SIMPLE or OVERLAP_COMPOUND) is drawn as FreeType draws it
    (``ft_smooth_raster_overlap``): four times larger, each 4 x 4 block's
    coverages rounded to sixteenths and summed, capped at 255."""
    if not len(pts):
        return GlyphBitmap(np.zeros((0, 0), np.uint8), 0, 0)
    pts = np.asarray(pts, np.int64)
    left, bottom = int(pts[:, 0].min()) >> 6, int(pts[:, 1].min()) >> 6
    right = (int(pts[:, 0].max()) + 63) >> 6
    top = (int(pts[:, 1].max()) + 63) >> 6
    width, height = max(right - left, 1), max(top - bottom, 1)
    k = 4 if overlap else 1
    local = (pts - np.array([left * 64, bottom * 64])) * k
    segs = _chords(*_decompose(local, np.asarray(on, bool), ends))
    cover, area = _cells(segs, width * k, height * k)
    coverage = _sweep(cover, area)
    if overlap:
        sixteenths = (coverage.astype(np.int64) + 8) >> 4
        coverage = np.minimum(sixteenths.reshape(height, 4, width, 4)
                              .sum(axis=(1, 3)), 255).astype(np.uint8)
    coverage = np.ascontiguousarray(coverage[::-1])
    coverage.flags.writeable = False        # shared through the cache
    return GlyphBitmap(coverage, left, top)


@functools.lru_cache(maxsize=8192)
def glyph_bitmap(face, size: int, gid: int) -> GlyphBitmap:
    """The coverage bitmap of glyph ``gid`` of ``face`` at ``size`` px,
    hinted as Pillow loads it."""
    return render(*face.hinted_outline(gid, size))
