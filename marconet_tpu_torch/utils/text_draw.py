"""Pillow's ``ImageDraw.text`` on numpy canvases, with the port's own
TrueType reader and hinting (``utils/truetype.py``, ``utils/ttinterp.py``)
and rasterizer (``utils/raster.py``): each glyph is Pillow's bitmap of it,
pixel for pixel.

``truetype(path, size)`` stands for ``PIL.ImageFont.truetype(path,
size)`` and :func:`draw_text` for ``ImageDraw.Draw(image).text(xy, text,
font=font, fill=fill)`` with the default anchor ``la`` (left, ascender),
on an ``L`` canvas (an (H, W) uint8 array) or an ``RGB`` one ((H, W, 3)
uint8), in place. The rules, each pinned against PIL in
``tests/test_torch_render.py``:

* the text is laid out as PIL's RAQM layout lays it out
  (:meth:`TrueTypeFace.shape`);
* the baseline lies ``ascender`` px below ``xy``, FreeType's size
  ascender rounded up to a whole pixel;
* each glyph's origin is its pen position rounded to the nearest whole
  pixel (half up), and its bitmap is placed from there;
* the glyphs of one string combine into one mask, each in turn, as ink
  255 blends through a mask: ``m + c - m * c / 255`` rounded in 8 bits
  (not by their maximum: overlapping anti-aliased edges add up);
* the mask blends into the canvas, each channel, as Pillow blends it:
  ``(dst * (255 - m) + ink * m) / 255`` rounded in 8 bits; pixels off the
  canvas are clipped.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from marconet_tpu_torch.utils.raster import glyph_bitmap
from marconet_tpu_torch.utils.truetype import TrueTypeFace, load_face


class Font:
    """A TrueType face at a size in pixels (``ImageFont.truetype``)."""

    def __init__(self, face: TrueTypeFace, size: int):
        self.face = face
        self.size = int(size)

    def getlength(self, text: str) -> float:
        """The text's advance in pixels, as PIL's ``getlength``."""
        return self.face.shape(text, self.size)[2] / 64

    def getmetrics(self) -> Tuple[int, int]:
        """(ascent, descent) in whole pixels, as PIL's ``getmetrics``."""
        return (self.face.ascender_px(self.size),
                self.face.descender_px(self.size))

    def getmask(self, text: str) -> Tuple[np.ndarray, Tuple[int, int]]:
        """(mask (h, w) uint8, (dx, dy)): the text's coverage, its glyphs
        composited one over the other, and the place of its top-left
        pixel relative to the ``xy`` the text is drawn at."""
        glyphs, xs, _ = self.face.shape(text, self.size)
        ascent = self.face.ascender_px(self.size)
        placed = []
        for gid, x in zip(glyphs, xs):
            bm = glyph_bitmap(self.face, self.size, gid)
            if bm.coverage.size:
                placed.append((bm.coverage, ((x + 32) >> 6) + bm.left,
                               ascent - bm.top))
        if not placed:
            return np.zeros((0, 0), np.uint8), (0, 0)
        x0 = min(p[1] for p in placed)
        y0 = min(p[2] for p in placed)
        x1 = max(p[1] + p[0].shape[1] for p in placed)
        y1 = max(p[2] + p[0].shape[0] for p in placed)
        mask = np.zeros((y1 - y0, x1 - x0), np.uint8)
        for cov, gx, gy in placed:
            blend(mask, cov, (gx - x0, gy - y0), 255)
        return mask, (x0, y0)


def truetype(path: str, size: int) -> Font:
    """The font of ``path`` at ``size`` px; the file is parsed once a
    process."""
    return Font(load_face(path), size)


def blend(canvas: np.ndarray, mask: np.ndarray, xy: Tuple[int, int],
          ink) -> None:
    """Pillow's ``draw_bitmap``: ``ink`` through ``mask`` placed with its
    top-left pixel at ``xy``, clipped to the canvas, in place."""
    x, y = xy
    h, w = mask.shape
    cx0, cy0 = max(x, 0), max(y, 0)
    cx1, cy1 = min(x + w, canvas.shape[1]), min(y + h, canvas.shape[0])
    if cx0 >= cx1 or cy0 >= cy1:
        return
    m = mask[cy0 - y:cy1 - y, cx0 - x:cx1 - x].astype(np.uint32)
    dst = canvas[cy0:cy1, cx0:cx1]
    if dst.ndim == 3:
        m = m[:, :, None]
    ink = np.asarray(ink, np.uint32)
    t = dst.astype(np.uint32) * (255 - m) + ink * m + 128
    dst[...] = ((t >> 8) + t) >> 8


def draw_text(canvas: np.ndarray, xy: Tuple[int, int], text: str,
              font: Font, fill: Union[int, Tuple[int, int, int]]) -> None:
    """``ImageDraw.Draw(canvas).text(xy, text, font=font, fill=fill)``:
    ``canvas`` is an (H, W) ``L`` or (H, W, 3) ``RGB`` uint8 array, drawn
    in place; ``fill`` an int or an RGB triple."""
    mask, (dx, dy) = font.getmask(text)
    if mask.size:
        blend(canvas, mask, (int(xy[0]) + dx, int(xy[1]) + dy), fill)
