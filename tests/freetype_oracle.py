"""Pillow's own FreeType, called through ``ctypes``: the oracle of the
port's glyph loader (``marconet_tpu_torch/utils/truetype.py``,
``ttinterp.py``) in the tests.

Pillow ships FreeType in ``site-packages/pillow.libs/libfreetype-*.so``;
importing ``PIL._imagingft`` first makes sure it is the build Pillow draws
with. :class:`Face` loads a glyph as ``ImageFont.truetype`` does
(``FT_Set_Pixel_Sizes(face, 0, size)``, ``FT_Load_Glyph`` with
``FT_LOAD_DEFAULT``: the TrueType bytecode interpreter, v40) or unhinted
(``FT_LOAD_NO_HINTING``), and returns its 26.6 points, tags, contour ends
and metrics, or the smooth rasterizer's 8-bit bitmap. Only tests use it.
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import NamedTuple, Optional

import numpy as np

FT_LOAD_DEFAULT = 0x0
FT_LOAD_NO_HINTING = 0x2
FT_LOAD_NO_BITMAP = 0x8
FT_RENDER_MODE_NORMAL = 0

c_long, c_int, c_uint = ctypes.c_long, ctypes.c_int, ctypes.c_uint
c_short, c_ushort, c_void_p = ctypes.c_short, ctypes.c_ushort, ctypes.c_void_p


class _Generic(ctypes.Structure):
    _fields_ = [("data", c_void_p), ("finalizer", c_void_p)]


class _BBox(ctypes.Structure):
    _fields_ = [("xMin", c_long), ("yMin", c_long), ("xMax", c_long),
                ("yMax", c_long)]


class _Vector(ctypes.Structure):
    _fields_ = [("x", c_long), ("y", c_long)]


class _Metrics(ctypes.Structure):
    _fields_ = [(n, c_long) for n in (
        "width", "height", "horiBearingX", "horiBearingY", "horiAdvance",
        "vertBearingX", "vertBearingY", "vertAdvance")]


class _Bitmap(ctypes.Structure):
    _fields_ = [("rows", c_uint), ("width", c_uint), ("pitch", c_int),
                ("buffer", ctypes.POINTER(ctypes.c_ubyte)),
                ("num_grays", c_ushort), ("pixel_mode", ctypes.c_ubyte),
                ("palette_mode", ctypes.c_ubyte), ("palette", c_void_p)]


class _Outline(ctypes.Structure):
    # FreeType 2.14: n_contours and n_points are unsigned short
    _fields_ = [("n_contours", c_ushort), ("n_points", c_ushort),
                ("points", ctypes.POINTER(_Vector)),
                ("tags", ctypes.POINTER(ctypes.c_ubyte)),
                ("contours", ctypes.POINTER(c_ushort)), ("flags", c_int)]


class _GlyphSlot(ctypes.Structure):
    _fields_ = [("library", c_void_p), ("face", c_void_p),
                ("next", c_void_p), ("glyph_index", c_uint),
                ("generic", _Generic), ("metrics", _Metrics),
                ("linearHoriAdvance", c_long),
                ("linearVertAdvance", c_long), ("advance", _Vector),
                ("format", c_uint), ("bitmap", _Bitmap),
                ("bitmap_left", c_int), ("bitmap_top", c_int),
                ("outline", _Outline)]


class _Face(ctypes.Structure):
    _fields_ = [("num_faces", c_long), ("face_index", c_long),
                ("face_flags", c_long), ("style_flags", c_long),
                ("num_glyphs", c_long), ("family_name", c_void_p),
                ("style_name", c_void_p), ("num_fixed_sizes", c_int),
                ("available_sizes", c_void_p), ("num_charmaps", c_int),
                ("charmaps", c_void_p), ("generic", _Generic),
                ("bbox", _BBox), ("units_per_EM", c_ushort),
                ("ascender", c_short), ("descender", c_short),
                ("height", c_short), ("max_advance_width", c_short),
                ("max_advance_height", c_short),
                ("underline_position", c_short),
                ("underline_thickness", c_short),
                ("glyph", ctypes.POINTER(_GlyphSlot)), ("size", c_void_p),
                ("charmap", c_void_p)]


class Glyph(NamedTuple):
    """A loaded glyph: 26.6 points (N, 2) y up, tags (N,) (bit 0 on
    curve), contour end indices, and the slot's metrics (26.6) and
    advance."""

    points: np.ndarray
    tags: np.ndarray
    ends: list
    metrics: dict


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Pillow's bundled libfreetype, loaded after ``PIL._imagingft``."""
    global _LIB
    if _LIB is None:
        import PIL
        from PIL import _imagingft  # noqa: F401  (loads the same build)

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                            "pillow.libs")
        found = sorted(glob.glob(os.path.join(libs, "libfreetype-*.so*")))
        if not found:
            raise RuntimeError(f"no libfreetype in {libs}")
        lib = ctypes.CDLL(found[0])
        lib.FT_Init_FreeType.argtypes = [ctypes.POINTER(c_void_p)]
        lib.FT_New_Face.argtypes = [c_void_p, ctypes.c_char_p, c_long,
                                    ctypes.POINTER(ctypes.POINTER(_Face))]
        lib.FT_New_Memory_Face.argtypes = [
            c_void_p, ctypes.c_char_p, c_long, c_long,
            ctypes.POINTER(ctypes.POINTER(_Face))]
        lib.FT_Set_Pixel_Sizes.argtypes = [ctypes.POINTER(_Face), c_uint,
                                           c_uint]
        lib.FT_Load_Glyph.argtypes = [ctypes.POINTER(_Face), c_uint,
                                      ctypes.c_int32]
        lib.FT_Render_Glyph.argtypes = [ctypes.POINTER(_GlyphSlot), c_int]
        lib.FT_Done_Face.argtypes = [ctypes.POINTER(_Face)]
        for fn in (lib.FT_Init_FreeType, lib.FT_New_Face,
                   lib.FT_New_Memory_Face, lib.FT_Set_Pixel_Sizes,
                   lib.FT_Load_Glyph, lib.FT_Render_Glyph, lib.FT_Done_Face):
            fn.restype = c_int                      # FT_Error
        lib.FT_Done_FreeType.argtypes = [c_void_p]
        lib.FT_Done_FreeType.restype = c_int
        _LIB = lib
    return _LIB


class Face:
    """One font file (or bytes) opened in its own FreeType library."""

    def __init__(self, path_or_bytes):
        lib = library()
        self._lib = lib
        self._handle = c_void_p()
        if lib.FT_Init_FreeType(ctypes.byref(self._handle)):
            raise RuntimeError("FT_Init_FreeType failed")
        self._face = ctypes.POINTER(_Face)()
        if isinstance(path_or_bytes, (bytes, bytearray)):
            self._data = ctypes.create_string_buffer(bytes(path_or_bytes),
                                                     len(path_or_bytes))
            err = lib.FT_New_Memory_Face(self._handle, self._data,
                                         len(path_or_bytes), 0,
                                         ctypes.byref(self._face))
        else:
            err = lib.FT_New_Face(self._handle, os.fsencode(path_or_bytes),
                                  0, ctypes.byref(self._face))
        if err:
            raise RuntimeError(f"FT_New_Face failed: {err}")
        self.size = None

    def set_size(self, size: int) -> None:
        if size != self.size:
            if self._lib.FT_Set_Pixel_Sizes(self._face, 0, size):
                raise RuntimeError(f"FT_Set_Pixel_Sizes({size}) failed")
            self.size = size

    def _load(self, gid: int, size: int, hinted: bool):
        self.set_size(size)
        flags = FT_LOAD_NO_BITMAP | (FT_LOAD_DEFAULT if hinted
                                     else FT_LOAD_NO_HINTING)
        err = self._lib.FT_Load_Glyph(self._face, gid, flags)
        if err:
            raise RuntimeError(f"FT_Load_Glyph({gid}) failed: {err}")
        return self._face.contents.glyph.contents

    def load(self, gid: int, size: int, hinted: bool = True) -> Glyph:
        """Glyph ``gid`` at ``size`` px, hinted as Pillow loads it or
        unhinted."""
        slot = self._load(gid, size, hinted)
        o = slot.outline
        n = o.n_points
        pts = np.array([(o.points[i].x, o.points[i].y) for i in range(n)],
                       np.int64).reshape(-1, 2)
        tags = np.array([o.tags[i] for i in range(n)], np.uint8)
        ends = [o.contours[i] for i in range(o.n_contours)]
        m = slot.metrics
        metrics = {name: getattr(m, name) for name, _ in _Metrics._fields_}
        metrics["advance_x"] = slot.advance.x
        metrics["linear_advance"] = slot.linearHoriAdvance
        return Glyph(pts, tags, ends, metrics)

    def bitmap(self, gid: int, size: int, hinted: bool = True):
        """(coverage (rows, width) uint8, left, top) of the smooth
        rasterizer on glyph ``gid`` at ``size`` px."""
        slot = self._load(gid, size, hinted)
        if self._lib.FT_Render_Glyph(ctypes.byref(slot),
                                     FT_RENDER_MODE_NORMAL):
            raise RuntimeError(f"FT_Render_Glyph({gid}) failed")
        bm = slot.bitmap
        rows, width, pitch = bm.rows, bm.width, bm.pitch
        if rows == 0 or width == 0:
            return np.zeros((0, 0), np.uint8), 0, 0
        buf = np.ctypeslib.as_array(bm.buffer, (rows * abs(pitch),))
        cov = buf.reshape(rows, abs(pitch))[:, :width].copy()
        if pitch < 0:
            cov = cov[::-1]
        return cov, slot.bitmap_left, slot.bitmap_top

    def close(self) -> None:
        if self._face:
            self._lib.FT_Done_Face(self._face)
            self._face = ctypes.POINTER(_Face)()
        if self._handle:
            self._lib.FT_Done_FreeType(self._handle)
            self._handle = c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
