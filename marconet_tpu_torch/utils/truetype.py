"""TrueType fonts in numpy and ``struct``: the sfnt reader and the text
shaping that Pillow's RAQM layout (libraqm over HarfBuzz) gives.

The JAX package draws text with ``PIL.ImageFont.truetype`` and
``ImageDraw.text`` (``marconet_tpu/data/synth.py``); the card's machine has
no PIL, so the port reads the font itself (:class:`TrueTypeFace`), lays the
text out here (:meth:`TrueTypeFace.shape`), loads glyphs here as
FreeType's TrueType module loads them, hinted by ``utils/ttinterp.py``,
rasterizes them in ``utils/raster.py`` and draws in
``utils/text_draw.py``.

Reader: the table directory, ``head``, ``hhea``, ``maxp`` (with version
1.0's limits for the interpreter), ``hmtx``, ``vhea`` / ``vmtx`` or
``OS/2``'s typographic metrics (the vertical phantom points), ``cmap``
(formats 4 and 12, Windows Unicode full repertoire (3, 10) before BMP
(3, 1); a character the font lacks is glyph 0, ``.notdef``), ``loca`` and
``glyf`` (simple glyphs with their instructions, flag repeats and delta
coordinates; composites with word or byte arguments, x/y offsets or
matched points, the three scale forms, their flags and instructions),
``cvt ``, ``fpgm``, ``prep``, and the ``GSUB`` / ``GPOS`` lookups that
shaping uses.

Glyph loading (:meth:`TrueTypeFace.load`), as ``TT_Load_Glyph``: a simple
glyph's points and its four phantom points are scaled to 26.6 with
``FT_MulFix``, its phantom points rounded and its program run; a
composite loads (and hints) each component at the size, transforms it in
16.16, moves it by its offset scaled alone (by ``FT_Hypot`` of the
transform for a scaled offset; rounded to the grid in y, and in x without
backward compatibility, when asked) or by matched hinted points, then
runs its own program on all of them; the outline is moved by the left
phantom point. Not here: FreeType auto-hints (a different module, not
the bytecode interpreter) a font that has no ``fpgm``; such a font is
hinted here by its own bytecode, if it has any.

Shaping, as RAQM and HarfBuzz shape a left-to-right line:

* the text is split into script runs; a Common character (digits,
  punctuation) takes the script of the run before it, a paired closing
  bracket that of its opening one, an Inherited one that of the character
  before it, and a leading Common run that of the run after it; each run
  is shaped alone;
* a run takes the font's script tag for its script (``DFLT``, then
  ``dflt``, then ``latn`` where the font has none), that script's default
  language system (its required feature included) and the default
  features: GSUB ``ccmp``, ``locl``, ``rlig``, ``calt``, ``clig``,
  ``liga`` and ``rclt``, GPOS ``kern``; the lookups of one table run in
  index order, each over the whole run;
* GSUB lookup types 1 (single), 4 (ligature) and 6 format 2 (class-based
  chaining context, whose nested lookups are single substitutions), and
  GPOS type 2 (pair adjustment, formats 1 and 2), each also behind a type
  7 / type 9 extension; other lookup types and formats are not applied
  (they adjust combining marks, cursive scripts and contextual forms,
  which the model's alphabet does not hold), and lookup flags are not
  applied (they skip marks);
* advances are unhinted: a glyph's advance is ``round(advance * size *
  64 / unitsPerEm)`` 1/64 px in FreeType's and HarfBuzz's integer
  arithmetic, a GPOS value is scaled as HarfBuzz scales it, and a Unicode
  space the font lacks takes the space glyph with HarfBuzz's fallback
  width (an em, or a fraction of one).

Positions are integers in 1/64 px (26.6 fixed point), as ``getlength``'s
``/ 64`` shows.
"""

from __future__ import annotations

import bisect
import functools
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from marconet_tpu_torch.utils import ttinterp

# composite glyph flags
_ARG_WORDS = 0x0001
_ARGS_XY = 0x0002
_ROUND_XY = 0x0004
_HAVE_SCALE = 0x0008
_MORE = 0x0020
_HAVE_XY_SCALE = 0x0040
_HAVE_2X2 = 0x0080
_HAVE_INSTRUCTIONS = 0x0100
_USE_MY_METRICS = 0x0200
_OVERLAP_COMPOUND = 0x0400
_SCALED_OFFSET = 0x0800
_OVERLAP_SIMPLE = 0x40        # a simple glyph's first point flag

GSUB_FEATURES = frozenset(
    [b"ccmp", b"locl", b"rlig", b"calt", b"clig", b"liga", b"rclt"])
GPOS_FEATURES = frozenset([b"kern"])

# Unicode spaces HarfBuzz draws with the space glyph where the font lacks
# them: the divisor of the em that gives the width
_SPACE_EM_DIVISOR = {0x2000: 2, 0x2001: 1, 0x2002: 2, 0x2003: 1,
                     0x2004: 3, 0x2005: 4, 0x2006: 6, 0x2009: 5,
                     0x200A: 16, 0x3000: 1}

# Unicode Script property of the blocks the shaper tells apart: (first,
# last, script); every other code point is Common. ``Zinh`` is Inherited.
_SCRIPT_RANGES = (
    (0x0041, 0x005A, "Latn"), (0x0061, 0x007A, "Latn"),
    (0x00AA, 0x00AA, "Latn"), (0x00BA, 0x00BA, "Latn"),
    (0x00C0, 0x00D6, "Latn"), (0x00D8, 0x00F6, "Latn"),
    (0x00F8, 0x02B8, "Latn"), (0x02E0, 0x02E4, "Latn"),
    (0x02EA, 0x02EB, "Bopo"), (0x0300, 0x036F, "Zinh"),
    (0x0370, 0x0373, "Grek"), (0x0375, 0x0377, "Grek"),
    (0x037A, 0x037D, "Grek"), (0x037F, 0x037F, "Grek"),
    (0x0384, 0x0384, "Grek"), (0x0386, 0x0386, "Grek"),
    (0x0388, 0x03E1, "Grek"), (0x03E2, 0x03EF, "Copt"),
    (0x03F0, 0x03FF, "Grek"), (0x0400, 0x0484, "Cyrl"),
    (0x0485, 0x0486, "Zinh"), (0x0487, 0x052F, "Cyrl"),
    (0x1100, 0x11FF, "Hang"), (0x1D00, 0x1D25, "Latn"),
    (0x1DC0, 0x1DFF, "Zinh"), (0x1E00, 0x1EFF, "Latn"),
    (0x1F00, 0x1FFE, "Grek"), (0x200C, 0x200D, "Zinh"),
    (0x20D0, 0x20F0, "Zinh"), (0x2160, 0x2188, "Latn"),
    (0x2E80, 0x2FD5, "Hani"), (0x3005, 0x3005, "Hani"),
    (0x3007, 0x3007, "Hani"), (0x3021, 0x3029, "Hani"),
    (0x302A, 0x302D, "Zinh"), (0x3038, 0x303B, "Hani"),
    (0x3041, 0x3096, "Hira"), (0x3099, 0x309A, "Zinh"),
    (0x309D, 0x309F, "Hira"), (0x30A1, 0x30FA, "Kana"),
    (0x30FD, 0x30FF, "Kana"), (0x3105, 0x312F, "Bopo"),
    (0x3131, 0x318E, "Hang"), (0x31A0, 0x31BF, "Bopo"),
    (0x31F0, 0x31FF, "Kana"), (0x3400, 0x4DBF, "Hani"),
    (0x4E00, 0x9FFF, "Hani"), (0xAC00, 0xD7A3, "Hang"),
    (0xF900, 0xFAD9, "Hani"), (0xFE00, 0xFE0F, "Zinh"),
    (0xFE20, 0xFE2D, "Zinh"), (0xFF21, 0xFF3A, "Latn"),
    (0xFF41, 0xFF5A, "Latn"), (0xFF66, 0xFF6F, "Kana"),
    (0xFF71, 0xFF9D, "Kana"), (0x20000, 0x323AF, "Hani"),
)
_SCRIPT_STARTS = [r[0] for r in _SCRIPT_RANGES]
# ISO 15924 code -> OpenType script tag
_OT_SCRIPT = {"Latn": b"latn", "Grek": b"grek", "Cyrl": b"cyrl",
              "Hani": b"hani", "Hira": b"kana", "Kana": b"kana",
              "Bopo": b"bopo", "Hang": b"hang", "Copt": b"copt"}
# the brackets libraqm pairs when it resolves Common characters
_PAIRED = (0x0028, 0x0029, 0x003C, 0x003E, 0x005B, 0x005D, 0x007B, 0x007D,
           0x00AB, 0x00BB, 0x2018, 0x2019, 0x201C, 0x201D, 0x2039, 0x203A,
           0x3008, 0x3009, 0x300A, 0x300B, 0x300C, 0x300D, 0x300E, 0x300F,
           0x3010, 0x3011, 0x3014, 0x3015, 0x3016, 0x3017, 0x3018, 0x3019,
           0x301A, 0x301B)
_PAIR_INDEX = {c: i for i, c in enumerate(_PAIRED)}


class FontError(ValueError):
    """A file that is not a TrueType font this reader can draw."""


def script(ch: str) -> str:
    """The Unicode Script property of ``ch`` as an ISO 15924 code, for the
    blocks of ``_SCRIPT_RANGES``; ``Zyyy`` (Common) elsewhere."""
    cp = ord(ch)
    i = bisect.bisect_right(_SCRIPT_STARTS, cp) - 1
    if i >= 0 and cp <= _SCRIPT_RANGES[i][1]:
        return _SCRIPT_RANGES[i][2]
    return "Zyyy"


def script_runs(text: str) -> List[Tuple[int, int, str]]:
    """(start, end, script) runs of ``text`` as libraqm itemizes them."""
    n = len(text)
    scripts = [script(c) for c in text]
    last_value: Optional[str] = None
    last_set = -1
    stack: List[Tuple[str, int]] = []
    for i in range(n):
        s = scripts[i]
        if s == "Zyyy" and last_value is not None:
            pair = _PAIR_INDEX.get(ord(text[i]))
            if pair is not None and pair % 2 == 1:
                # a closing bracket: the script of its opening one
                while stack and stack[-1][1] != pair - 1:
                    stack.pop()
                if stack:
                    last_value = stack[-1][0]
            elif pair is not None:
                stack.append((last_value, pair))
            scripts[i] = last_value
            last_set = i
        elif s == "Zinh" and last_value is not None:
            scripts[i] = last_value
            last_set = i
        elif s not in ("Zyyy", "Zinh"):
            for j in range(last_set + 1, i):
                scripts[j] = s
            last_value = s
            last_set = i
    for i in range(n - 2, -1, -1):
        if scripts[i] in ("Zyyy", "Zinh"):
            scripts[i] = scripts[i + 1]
    runs: List[Tuple[int, int, str]] = []
    for i, s in enumerate(scripts):
        if runs and runs[-1][2] == s:
            runs[-1] = (runs[-1][0], i + 1, s)
        else:
            runs.append((i, i + 1, s))
    return runs


_mul_fix = ttinterp.mul_fix


# ---------------------------------------------------------------------------
# OpenType layout tables
# ---------------------------------------------------------------------------


def _u16(data: bytes, off: int) -> int:
    return (data[off] << 8) | data[off + 1]


def _coverage(data: bytes, off: int) -> Dict[int, int]:
    """glyph -> coverage index."""
    fmt = _u16(data, off)
    n = _u16(data, off + 2)
    if fmt == 1:
        glyphs = struct.unpack_from(f">{n}H", data, off + 4)
        return {g: i for i, g in enumerate(glyphs)}
    out = {}
    for k in range(n):
        start, end, base = struct.unpack_from(">3H", data, off + 4 + 6 * k)
        for g in range(start, end + 1):
            out[g] = base + g - start
    return out


def _class_def(data: bytes, off: int) -> Dict[int, int]:
    """glyph -> class (class 0 is left out)."""
    fmt = _u16(data, off)
    if fmt == 1:
        first, n = struct.unpack_from(">2H", data, off + 2)
        classes = struct.unpack_from(f">{n}H", data, off + 6)
        return {first + i: c for i, c in enumerate(classes) if c}
    n = _u16(data, off + 2)
    out = {}
    for k in range(n):
        start, end, c = struct.unpack_from(">3H", data, off + 4 + 6 * k)
        if c:
            for g in range(start, end + 1):
                out[g] = c
    return out


def _value_len(fmt: int) -> int:
    """Bytes of a ValueRecord of format ``fmt`` (its 8 fields, 2 each)."""
    return 2 * bin(fmt & 0xFF).count("1")


def _value(data: bytes, off: int, fmt: int) -> Tuple[int, int]:
    """(x placement, x advance) of a ValueRecord, in font units: fields 0
    and 2 of the ones ``fmt`` holds, in field order."""
    fields = [bit for bit in range(8) if fmt & (1 << bit)]
    vals = struct.unpack_from(f">{len(fields)}h", data, off)
    got = dict(zip(fields, vals))
    return got.get(0, 0), got.get(2, 0)


class _Layout:
    """The script list, feature list and the supported lookups of one
    GSUB or GPOS table."""

    def __init__(self, data: bytes, is_gpos: bool):
        self.data = data
        self.is_gpos = is_gpos
        script_off, feature_off, lookup_off = struct.unpack_from(
            ">3H", data, 4)
        self.scripts: Dict[bytes, Tuple[int, List[int]]] = {}
        n = _u16(data, script_off)
        for k in range(n):
            tag = data[script_off + 2 + 6 * k:script_off + 6 + 6 * k]
            off = script_off + _u16(data, script_off + 6 + 6 * k)
            default = _u16(data, off)
            if default:
                ls = off + default
                req, count = struct.unpack_from(">2H", data, ls + 2)
                feats = list(struct.unpack_from(f">{count}H", data, ls + 6))
                self.scripts[tag] = (req, feats)
        self.features: List[Tuple[bytes, List[int]]] = []
        n = _u16(data, feature_off)
        for k in range(n):
            rec = feature_off + 2 + 6 * k
            tag = data[rec:rec + 4]
            off = feature_off + _u16(data, rec + 4)
            count = _u16(data, off + 2)
            self.features.append(
                (tag, list(struct.unpack_from(f">{count}H", data, off + 4))))
        n = _u16(data, lookup_off)
        offs = struct.unpack_from(f">{n}H", data, lookup_off + 2)
        self.lookups = [self._lookup(lookup_off + o) for o in offs]
        self._plans: Dict[bytes, List[int]] = {}

    def _lookup(self, off: int):
        data = self.data
        kind, _flag, n = struct.unpack_from(">3H", data, off)
        subs = []
        for o in struct.unpack_from(f">{n}H", data, off + 6):
            sub, sub_kind = off + o, kind
            if kind == (9 if self.is_gpos else 7):      # extension
                sub_kind = _u16(data, sub + 2)
                sub += struct.unpack_from(">I", data, sub + 4)[0]
            parsed = self._subtable(sub_kind, sub)
            if parsed is not None:
                subs.append(parsed)
        return subs

    def _subtable(self, kind: int, off: int):
        data = self.data
        fmt = _u16(data, off)
        if self.is_gpos:
            return self._pair(off) if kind == 2 else None
        if kind == 1:
            cov = _coverage(data, off + _u16(data, off + 2))
            if fmt == 1:
                delta = struct.unpack_from(">h", data, off + 4)[0]
                return ("single", {g: (g + delta) & 0xFFFF for g in cov})
            n = _u16(data, off + 4)
            subst = struct.unpack_from(f">{n}H", data, off + 6)
            return ("single", {g: subst[i] for g, i in cov.items()})
        if kind == 4:
            cov = _coverage(data, off + _u16(data, off + 2))
            n = _u16(data, off + 4)
            sets = struct.unpack_from(f">{n}H", data, off + 6)
            ligs: Dict[int, List[Tuple[Tuple[int, ...], int]]] = {}
            for g, i in cov.items():
                so = off + sets[i]
                cands = []
                for lo in struct.unpack_from(f">{_u16(data, so)}H",
                                             data, so + 2):
                    lig, count = struct.unpack_from(">2H", data, so + lo)
                    comps = struct.unpack_from(f">{count - 1}H", data,
                                               so + lo + 4)
                    cands.append((tuple(comps), lig))
                ligs[g] = cands
            return ("ligature", ligs)
        if kind == 6 and fmt == 2:
            return self._chain_classes(off)
        return None

    def _chain_classes(self, off: int):
        data = self.data
        (cov_o, back_o, in_o, ahead_o, n) = struct.unpack_from(
            ">5H", data, off + 2)
        rules = {}
        for c, so in enumerate(struct.unpack_from(f">{n}H", data, off + 12)):
            if not so:
                continue
            so += off
            cands = []
            for ro in struct.unpack_from(f">{_u16(data, so)}H", data, so + 2):
                p = so + ro
                seqs = []
                for drop in (0, 1, 0):  # the input count holds its first
                    count = _u16(data, p) - drop
                    seqs.append(struct.unpack_from(f">{count}H", data,
                                                   p + 2))
                    p += 2 + 2 * count
                count = _u16(data, p)
                recs = [struct.unpack_from(">2H", data, p + 2 + 4 * k)
                        for k in range(count)]
                cands.append((seqs[0], seqs[1], seqs[2], recs))
            rules[c] = cands
        return ("chain", _coverage(data, off + cov_o),
                _class_def(data, off + back_o), _class_def(data, off + in_o),
                _class_def(data, off + ahead_o), rules)

    def _pair(self, off: int):
        data = self.data
        fmt, cov_o, vf1, vf2 = struct.unpack_from(">4H", data, off)
        cov = _coverage(data, off + cov_o)
        len1, len2 = _value_len(vf1), _value_len(vf2)
        if fmt == 1:
            n = _u16(data, off + 8)
            set_offs = struct.unpack_from(f">{n}H", data, off + 10)
            pairs: Dict[int, Dict[int, tuple]] = {}
            for g, i in cov.items():
                so = off + set_offs[i]
                table = {}
                for k in range(_u16(data, so)):
                    rec = so + 2 + k * (2 + len1 + len2)
                    second = _u16(data, rec)
                    table[second] = (_value(data, rec + 2, vf1),
                                     _value(data, rec + 2 + len1, vf2))
                pairs[g] = table
            return ("pair1", pairs, len2 > 0)
        cd1_o, cd2_o, n1, n2 = struct.unpack_from(">4H", data, off + 8)
        values = []
        rec = off + 16
        for _ in range(n1 * n2):
            values.append((_value(data, rec, vf1),
                           _value(data, rec + len1, vf2)))
            rec += len1 + len2
        return ("pair2", cov, _class_def(data, off + cd1_o),
                _class_def(data, off + cd2_o), n2, values, len2 > 0)

    def plan(self, script_tags: Sequence[bytes],
             wanted: frozenset) -> List[int]:
        """Lookup indices, in order, of the wanted features of the first
        of ``script_tags`` (then ``DFLT``, ``dflt``, ``latn``) the table
        has, and of its required feature."""
        key = tuple(script_tags)
        if key not in self._plans:
            chosen = None
            for tag in (*script_tags, b"DFLT", b"dflt", b"latn"):
                if tag in self.scripts:
                    chosen = self.scripts[tag]
                    break
            lookups = set()
            if chosen is not None:
                req, feats = chosen
                if req != 0xFFFF:
                    lookups.update(self.features[req][1])
                for fi in feats:
                    tag, idx = self.features[fi]
                    if tag in wanted:
                        lookups.update(idx)
            self._plans[key] = sorted(lookups)
        return self._plans[key]


def _apply_gsub(layout: _Layout, lookups: List[int], glyphs: List[int]):
    """Each lookup over the whole run, position by position; at each
    position the first subtable that applies wins."""
    for li in lookups:
        subs = layout.lookups[li]
        i = 0
        while i < len(glyphs):
            nxt = None
            for sub in subs:
                nxt = _SUBST[sub[0]](layout, sub, glyphs, i)
                if nxt is not None:
                    break
            i = i + 1 if nxt is None else nxt


def _single(layout, sub, glyphs: List[int], i: int) -> Optional[int]:
    g = sub[1].get(glyphs[i])
    if g is None:
        return None
    glyphs[i] = g
    return i + 1


def _ligature(layout, sub, glyphs: List[int], i: int) -> Optional[int]:
    for comps, lig in sub[1].get(glyphs[i], ()):
        end = i + 1 + len(comps)
        if tuple(glyphs[i + 1:end]) == comps:
            glyphs[i:end] = [lig]
            return i + 1
    return None


def _chain(layout, sub, glyphs: List[int], i: int) -> Optional[int]:
    _, cov, back_cd, in_cd, ahead_cd, rules = sub
    if glyphs[i] not in cov:
        return None
    for back, inp, ahead, recs in rules.get(in_cd.get(glyphs[i], 0), ()):
        end = i + 1 + len(inp)
        if i < len(back) or end + len(ahead) > len(glyphs):
            continue
        if any(back_cd.get(glyphs[i - 1 - k], 0) != c
               for k, c in enumerate(back)) \
                or any(in_cd.get(glyphs[i + 1 + k], 0) != c
                       for k, c in enumerate(inp)) \
                or any(ahead_cd.get(glyphs[end + k], 0) != c
                       for k, c in enumerate(ahead)):
            continue
        for seq, li in recs:
            for nested in layout.lookups[li]:
                if nested[0] == "single" and \
                        _single(layout, nested, glyphs, i + seq) is not None:
                    break
        return end
    return None


_SUBST = {"single": _single, "ligature": _ligature, "chain": _chain}


def _apply_gpos(layout: _Layout, lookups: List[int], glyphs: List[int],
                advance: List[int], offset: List[int], scale: int,
                upem: int):
    mult = (scale << 16) // upem

    def em(v: int) -> int:               # HarfBuzz's em_mult
        return (v * mult + 32768) >> 16

    for li in lookups:
        subs = layout.lookups[li]
        i = 0
        while i < len(glyphs) - 1:
            step = 1
            for sub in subs:
                first, second = glyphs[i], glyphs[i + 1]
                if sub[0] == "pair1":
                    found = sub[1].get(first, {}).get(second)
                    if found is None:
                        continue
                    values, skip = found, sub[2]
                else:
                    _, cov, cd1, cd2, n2, table, skip = sub
                    if first not in cov:
                        continue
                    values = table[cd1.get(first, 0) * n2 + cd2.get(second, 0)]
                for k, (dx, adv) in enumerate(values):
                    offset[i + k] += em(dx)
                    advance[i + k] += em(adv)
                step = 2 if skip else 1
                break
            i += step


# ---------------------------------------------------------------------------
# the face
# ---------------------------------------------------------------------------


class TrueTypeFace:
    """One TrueType font file, parsed: metrics, character map, outlines
    and layout lookups. Sizes are chosen per call; see
    ``utils/text_draw.py`` for a font at a size."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self.data = data
        if len(data) < 12 or data[:4] not in (b"\x00\x01\x00\x00", b"true"):
            raise FontError(f"{path}: not a TrueType font")
        n = _u16(data, 4)
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        for k in range(n):
            tag, _sum, off, length = struct.unpack_from(">4s3I", data,
                                                        12 + 16 * k)
            self.tables[tag] = (off, length)
        for tag in (b"head", b"hhea", b"maxp", b"hmtx", b"cmap", b"loca",
                    b"glyf"):
            if tag not in self.tables:
                raise FontError(f"{path}: no {tag.decode()} table")
        head = self.tables[b"head"][0]
        self.units_per_em = _u16(data, head + 18)
        self.index_to_loc = struct.unpack_from(">h", data, head + 50)[0]
        hhea = self.tables[b"hhea"][0]
        self.ascender, self.descender = struct.unpack_from(">2h", data,
                                                           hhea + 4)
        n_hmetrics = _u16(data, hhea + 34)
        self.num_glyphs = _u16(data, self.tables[b"maxp"][0] + 4)
        hmtx = self.tables[b"hmtx"][0]
        metrics = np.frombuffer(data, ">u2", 2 * n_hmetrics, hmtx)
        adv = metrics[0::2].astype(np.int64)
        lsb = metrics[1::2].astype(np.int16).astype(np.int64)
        extra = self.num_glyphs - n_hmetrics
        self.advances = np.concatenate(
            [adv, np.full(extra, adv[-1], np.int64)])
        self.lsb = np.concatenate([lsb, np.frombuffer(
            data, ">i2", extra, hmtx + 4 * n_hmetrics).astype(np.int64)])
        loca = self.tables[b"loca"][0]
        if self.index_to_loc == 0:
            self.loca = np.frombuffer(data, ">u2", self.num_glyphs + 1,
                                      loca).astype(np.int64) * 2
        else:
            self.loca = np.frombuffer(data, ">u4", self.num_glyphs + 1,
                                      loca).astype(np.int64)
        self.glyf = self.tables[b"glyf"][0]
        self.cmap = self._read_cmap()
        self.space_glyph = self.cmap.get(0x20, 0)
        self.gsub = (_Layout(self._table(b"GSUB"), False)
                     if b"GSUB" in self.tables else None)
        self.gpos = (_Layout(self._table(b"GPOS"), True)
                     if b"GPOS" in self.tables else None)
        self._read_hinting_tables()
        self._records: Dict[int, object] = {}
        self._outlines: Dict[int, tuple] = {}
        self._hinting: Optional[ttinterp.FontHinting] = None

    def _read_hinting_tables(self) -> None:
        """``cvt `` (FWORDs), ``fpgm``, ``prep``, ``maxp`` 1.0's limits,
        the vertical metrics behind the phantom points (``vhea`` /
        ``vmtx``, else ``OS/2``'s typographic ascender and descender, else
        ``hhea``'s)."""
        data = self.data
        cvt = self._table(b"cvt ") if b"cvt " in self.tables else b""
        self.cvt = list(struct.unpack(f">{len(cvt) // 2}h",
                                      cvt[:len(cvt) // 2 * 2]))
        self.fpgm = self._table(b"fpgm") if b"fpgm" in self.tables else b""
        self.prep = self._table(b"prep") if b"prep" in self.tables else b""
        maxp, maxp_len = self.tables[b"maxp"]
        if _u16(data, maxp) == 1 and maxp_len >= 32:
            (_, _, _, _, _, self.max_twilight, self.max_storage,
             self.max_fdefs, self.max_idefs, self.max_stack) = \
                struct.unpack_from(">10H", data, maxp + 6)
        else:
            self.max_twilight = self.max_storage = self.max_fdefs = 0
            self.max_idefs = self.max_stack = 0
        self.vmetrics = None
        if b"vhea" in self.tables and b"vmtx" in self.tables:
            n_vmetrics = _u16(data, self.tables[b"vhea"][0] + 34)
            vmtx = self.tables[b"vmtx"][0]

            def vmetrics(gid: int) -> Tuple[int, int]:
                k = min(gid, n_vmetrics - 1)
                adv = _u16(data, vmtx + 4 * k)
                at = (vmtx + 4 * gid + 2 if gid < n_vmetrics else
                      vmtx + 4 * n_vmetrics + 2 * (gid - n_vmetrics))
                return struct.unpack_from(">h", data, at)[0], adv
            self.vmetrics = vmetrics
        if b"OS/2" in self.tables:
            self.typo_metrics = struct.unpack_from(
                ">2h", data, self.tables[b"OS/2"][0] + 68)
        else:
            self.typo_metrics = (self.ascender, self.descender)

    def _table(self, tag: bytes) -> bytes:
        off, length = self.tables[tag]
        return self.data[off:off + length]

    # -- character map -----------------------------------------------------

    def _read_cmap(self) -> Dict[int, int]:
        data = self.data
        base = self.tables[b"cmap"][0]
        subtables = {}
        for k in range(_u16(data, base + 2)):
            plat, enc, off = struct.unpack_from(">2HI", data, base + 4 + 8 * k)
            subtables[(plat, enc)] = base + off
        for key in ((3, 10), (3, 1)):
            if key in subtables:
                off = subtables[key]
                fmt = _u16(data, off)
                if fmt == 12:
                    return self._cmap12(off)
                if fmt == 4:
                    return self._cmap4(off)
        raise FontError(f"{self.path}: no Windows Unicode cmap of format 4 "
                        "or 12")

    def _cmap4(self, off: int) -> Dict[int, int]:
        data = self.data
        seg = _u16(data, off + 6) // 2
        ends = struct.unpack_from(f">{seg}H", data, off + 14)
        starts = struct.unpack_from(f">{seg}H", data, off + 16 + 2 * seg)
        deltas = struct.unpack_from(f">{seg}h", data, off + 16 + 4 * seg)
        range_base = off + 16 + 6 * seg
        ranges = struct.unpack_from(f">{seg}H", data, range_base)
        out = {}
        for k in range(seg):
            if starts[k] == 0xFFFF:
                continue
            for c in range(starts[k], ends[k] + 1):
                if ranges[k] == 0:
                    g = (c + deltas[k]) & 0xFFFF
                else:
                    at = range_base + 2 * k + ranges[k] + 2 * (c - starts[k])
                    g = _u16(data, at)
                    if g:
                        g = (g + deltas[k]) & 0xFFFF
                if g:
                    out[c] = g
        return out

    def _cmap12(self, off: int) -> Dict[int, int]:
        n = struct.unpack_from(">I", self.data, off + 12)[0]
        groups = np.frombuffer(self.data, ">u4", 3 * n, off + 16)
        out = {}
        for start, end, glyph in groups.reshape(n, 3).tolist():
            for c in range(start, end + 1):
                out[c] = glyph + c - start
        return out

    def glyph_index(self, ch: str) -> int:
        """The glyph of ``ch``; 0 (``.notdef``) where the font has none."""
        return self.cmap.get(ord(ch), 0)

    # -- outlines ----------------------------------------------------------

    def _record(self, gid: int):
        """Glyph ``gid``'s ``glyf`` entry, parsed once: None for an empty
        glyph, else ``(bbox, simple, body, program)``: a simple glyph's
        body is (x list, y list, on-curve list, contour ends, whether it
        is flagged OVERLAP_SIMPLE), a composite's its components (flags,
        glyph, arg1, arg2, 16.16 transform (xx, yx, xy, yy) or None);
        ``program`` its instructions (a ``ttinterp.Program``) or None."""
        got = self._records.get(gid, False)
        if got is not False:
            return got
        rec = None
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end > start:
            data, off = self.data, self.glyf + start
            n_contours, *bbox = struct.unpack_from(">5h", data, off)
            if n_contours > 0:
                rec = self._simple(off, n_contours, tuple(bbox))
            elif n_contours < 0:
                rec = self._composite(off + 10, tuple(bbox))
        self._records[gid] = rec
        return rec

    def _simple(self, off: int, n_contours: int, bbox):
        data = self.data
        ends = list(struct.unpack_from(f">{n_contours}H", data, off + 10))
        n = ends[-1] + 1
        p = off + 10 + 2 * n_contours
        n_ins = _u16(data, p)
        program = (ttinterp.Program(data[p + 2:p + 2 + n_ins]) if n_ins
                   else None)
        p += 2 + n_ins
        flags = []
        while len(flags) < n:
            f = data[p]
            p += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * data[p])
                p += 1
        flags = flags[:n]
        axes = []
        for short, same in ((0x02, 0x10), (0x04, 0x20)):
            v = 0
            col = []
            for f in flags:
                if f & short:
                    d = data[p]
                    p += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += struct.unpack_from(">h", data, p)[0]
                    p += 2
                col.append(v)
            axes.append(col)
        on = [bool(f & 1) for f in flags]
        overlap = bool(flags[0] & _OVERLAP_SIMPLE)
        return bbox, True, (axes[0], axes[1], on, ends, overlap), program

    def _composite(self, p: int, bbox):
        data = self.data
        comps = []
        while True:
            flags, child = struct.unpack_from(">2H", data, p)
            p += 4
            if flags & _ARG_WORDS:
                fmt = ">2h" if flags & _ARGS_XY else ">2H"
                a1, a2 = struct.unpack_from(fmt, data, p)
                p += 4
            else:
                fmt = ">2b" if flags & _ARGS_XY else ">2B"
                a1, a2 = struct.unpack_from(fmt, data, p)
                p += 2
            m = None
            if flags & _HAVE_SCALE:
                xx = struct.unpack_from(">h", data, p)[0] * 4
                m = (xx, 0, 0, xx)
                p += 2
            elif flags & _HAVE_XY_SCALE:
                xx, yy = struct.unpack_from(">2h", data, p)
                m = (xx * 4, 0, 0, yy * 4)
                p += 4
            elif flags & _HAVE_2X2:
                m = tuple(v * 4 for v in struct.unpack_from(">4h", data, p))
                p += 8
            comps.append((flags, child, a1, a2, m))
            if not flags & _MORE:
                break
        program = None
        if flags & _HAVE_INSTRUCTIONS:
            n_ins = _u16(data, p)
            if n_ins:
                program = ttinterp.Program(data[p + 2:p + 2 + n_ins])
        return bbox, False, comps, program

    def outline(self, gid: int):
        """(points (N, 2) int64 font units, on-curve (N,) bool, contour
        end indices) of glyph ``gid``, composites resolved as FreeType
        resolves them unscaled (``FT_LOAD_NO_SCALE``); cached."""
        if gid not in self._outlines:
            self._outlines[gid] = self.load(gid, None, hinted=False)[:3]
        return self._outlines[gid]

    def hinted_outline(self, gid: int, size: int) -> "GlyphOutline":
        """Glyph ``gid`` at ``size`` px as Pillow loads it (FreeType's
        ``FT_LOAD_DEFAULT``: scaled and hinted)."""
        return self.load(gid, size, hinted=True)

    def x_min(self, gid: int) -> int:
        """``xMin`` of the glyph's ``glyf`` header (0 for an empty one)."""
        rec = self._record(gid)
        return rec[0][0] if rec is not None else 0

    def hinting(self) -> ttinterp.FontHinting:
        """The font's bytecode interpreter, its ``fpgm`` run once."""
        if self._hinting is None:
            self._hinting = ttinterp.FontHinting(
                cvt=self.cvt, fpgm=self.fpgm, prep=self.prep,
                max_stack=self.max_stack, max_storage=self.max_storage,
                max_twilight=self.max_twilight, max_fdefs=self.max_fdefs,
                max_idefs=self.max_idefs)
        return self._hinting

    def load(self, gid: int, size: Optional[int],
             hinted: bool = True) -> "GlyphOutline":
        """Glyph ``gid`` loaded as FreeType's TrueType module loads it
        (``TT_Load_Glyph``): at ``size`` px in 26.6, hinted or not, or in
        font units for ``size`` None; the outline starts at the glyph
        origin (moved by the left phantom point)."""
        scale = self.scale(size) if size is not None else None
        state = None
        if hinted and scale is not None:
            hint = self.hinting()
            state = hint.size(size, scale)
            if state.error:
                raise FontError(f"{self.path}: the font's hinting program "
                                f"failed at {size} px ({state.error})")
            if state.gs.instruct_control & 1:      # prep turned hinting off
                state = None
            else:
                hint.start_glyph(state)
        out = _Outline()
        pp = self._load(out, gid, 0, scale, state)
        xs, ys = out.x, out.y
        if pp[0][0]:
            xs = [v - pp[0][0] for v in xs]
        pts = np.array([xs, ys], np.int64).T.reshape(-1, 2)
        return GlyphOutline(pts, np.array(out.on, bool), out.ends,
                            out.overlap)

    def _phantoms(self, gid: int, bbox):
        """The four phantom points in font units (``TT_LOADER_SET_PP``)."""
        x_min, _, _, y_max = bbox
        pp1x = x_min - int(self.lsb[gid])
        if self.vmetrics is not None:
            tsb, vadv = self.vmetrics(gid)
        else:
            asc, desc = self.typo_metrics
            tsb, vadv = asc - y_max, abs(asc - desc)
        pp3y = y_max + tsb
        return [pp1x, pp1x + int(self.advances[gid]), 0, 0], \
            [0, 0, pp3y, pp3y - vadv]

    def _load(self, out: "_Outline", gid: int, depth: int,
              scale: Optional[int], state) -> List[Tuple[int, int]]:
        """``load_truetype_glyph``: append glyph ``gid``'s points to
        ``out``; its phantom points (scaled) after loading."""
        if depth > 8:
            raise FontError(f"{self.path}: composite glyph {gid} nests too "
                            "deep")
        if not 0 <= gid < self.num_glyphs:
            raise FontError(f"{self.path}: no glyph {gid}")
        rec = self._record(gid)
        px, py = self._phantoms(gid, rec[0] if rec else (0, 0, 0, 0))

        def scaled(v):
            return [_mul_fix(a, scale) for a in v] if scale is not None \
                else list(v)

        if rec is None or not rec[1]:
            pp = list(zip(scaled(px), scaled(py)))
            if rec is None:
                return pp
            return self._load_composite(out, rec, depth, scale, state, pp)
        _, _, (xs, ys, on, ends, overlap), program = rec
        out.overlap |= overlap
        n = len(xs)
        ux, uy = xs + px, ys + py
        cx, cy = scaled(ux), scaled(uy)
        pp = list(zip(cx[n:], cy[n:]))
        tags = [int(v) for v in on] + [0] * 4
        if state is not None:
            zone = ttinterp.Zone.glyph(cx, cy, tags, ends, ux, uy)
            if not self.hinting().hint(state, zone, program, False):
                pp = list(zip(zone.cx[n:], zone.cy[n:]))
            cx, cy, tags = zone.cx, zone.cy, zone.tags
        base = len(out.x)
        out.x.extend(cx[:n])
        out.y.extend(cy[:n])
        out.on.extend(bool(t & 1) for t in tags[:n])
        out.ends.extend(e + base for e in ends)
        return pp

    def _load_composite(self, out: "_Outline", rec, depth: int,
                        scale: Optional[int], state, pp):
        _, _, comps, program = rec
        start_point, start_contour = len(out.x), len(out.ends)
        # FreeType reads OVERLAP_COMPOUND on the first component only
        out.overlap |= bool(comps[0][0] & _OVERLAP_COMPOUND)
        for flags, child, a1, a2, m in comps:
            base = len(out.x)
            got = self._load(out, child, depth + 1, scale, state)
            if flags & _USE_MY_METRICS:
                pp = got
            if len(out.x) == base:
                continue
            self._place(out, flags, a1, a2, m, start_point, base, scale,
                        state)
        if state is None or not comps[-1][0] & _HAVE_INSTRUCTIONS \
                or len(out.x) <= start_point or program is None:
            return pp
        n = len(out.x) - start_point
        zone = ttinterp.Zone.glyph(
            out.x[start_point:] + [p[0] for p in pp],
            out.y[start_point:] + [p[1] for p in pp],
            [int(v) for v in out.on[start_point:]] + [0] * 4,
            [e - start_point for e in out.ends[start_contour:]])
        if not self.hinting().hint(state, zone, program, True):
            pp = list(zip(zone.cx[n:], zone.cy[n:]))
        out.x[start_point:] = zone.cx[:n]
        out.y[start_point:] = zone.cy[:n]
        out.on[start_point:] = [bool(t & 1) for t in zone.tags[:n]]
        return pp

    def _place(self, out: "_Outline", flags: int, a1: int, a2: int, m,
               start_point: int, base: int, scale: Optional[int],
               state) -> None:
        """``TT_Process_Composite_Component``: transform the component
        just loaded (points ``base:``) and move it to its place."""
        xs, ys = out.x, out.y
        if m is not None:
            xx, yx, xy, yy = m
            for i in range(base, len(xs)):
                x, y = xs[i], ys[i]
                xs[i] = _mul_fix(x, xx) + _mul_fix(y, xy)
                ys[i] = _mul_fix(x, yx) + _mul_fix(y, yy)
        if not flags & _ARGS_XY:                 # matched points
            k, l = a1 + start_point, a2 + base
            if k >= base or l >= len(xs):
                raise FontError(f"{self.path}: a composite glyph matches "
                                "a point it does not have")
            dx, dy = xs[k] - xs[l], ys[k] - ys[l]
        else:
            dx, dy = a1, a2
            if not dx and not dy:
                return
            if m is not None and flags & _SCALED_OFFSET:
                xx, yx, xy, yy = m
                dx = _mul_fix(dx, ttinterp.hypot(xx, xy))
                dy = _mul_fix(dy, ttinterp.hypot(yy, yx))
            if scale is not None:
                dx, dy = _mul_fix(dx, scale), _mul_fix(dy, scale)
                if flags & _ROUND_XY and state is not None:
                    # v40 rounds x only without backward compatibility
                    if not self.hinting().e.backward_compatibility:
                        dx = (dx + 32) & -64
                    dy = (dy + 32) & -64
        if dx or dy:
            for i in range(base, len(xs)):
                xs[i] += dx
                ys[i] += dy

    # -- layout ------------------------------------------------------------

    def scale(self, size: int) -> int:
        """FreeType's 16.16 scale of font units to 26.6 pixels for a
        nominal size of ``size`` px (``FT_DivFix(size * 64,
        unitsPerEm)``)."""
        upem = self.units_per_em
        return ((size * 64 << 16) + upem // 2) // upem

    def ascender_px(self, size: int) -> int:
        """FreeType's size ascender in whole pixels (rounded up)."""
        return -(-_mul_fix(self.ascender, self.scale(size)) // 64)

    def descender_px(self, size: int) -> int:
        """FreeType's size descender in whole pixels below the baseline
        (rounded away from it)."""
        return -(_mul_fix(self.descender, self.scale(size)) // 64)

    def shape(self, text: str, size: int
              ) -> Tuple[List[int], List[int], int]:
        """(glyphs, pen x of each glyph's origin in 1/64 px, total advance
        in 1/64 px) of ``text`` at ``size`` px, laid out left to right."""
        scale = self.scale(size)
        hb_scale = (scale * self.units_per_em + (1 << 15)) >> 16
        glyphs_out: List[int] = []
        xs: List[int] = []
        pen = 0
        for start, end, run_script in script_runs(text):
            tags = [_OT_SCRIPT[run_script]] if run_script in _OT_SCRIPT \
                else []
            # a space the font lacks goes through GSUB as -divisor (no
            # lookup covers it), then becomes the space glyph
            glyphs = []
            for ch in text[start:end]:
                g = self.glyph_index(ch)
                div = _SPACE_EM_DIVISOR.get(ord(ch))
                glyphs.append(-div if g == 0 and div and self.space_glyph
                              else g)
            if self.gsub is not None:
                _apply_gsub(self.gsub, self.gsub.plan(tags, GSUB_FEATURES),
                            glyphs)
            advance = [(hb_scale + -g // 2) // -g if g < 0
                       else self._advance26(g, scale) for g in glyphs]
            glyphs = [self.space_glyph if g < 0 else g for g in glyphs]
            offset = [0] * len(glyphs)
            if self.gpos is not None:
                _apply_gpos(self.gpos, self.gpos.plan(tags, GPOS_FEATURES),
                            glyphs, advance, offset, hb_scale,
                            self.units_per_em)
            for g, a, o in zip(glyphs, advance, offset):
                glyphs_out.append(g)
                xs.append(pen + o)
                pen += a
        return glyphs_out, xs, pen

    def _advance26(self, gid: int, scale: int) -> int:
        """HarfBuzz's advance through FreeType (``FT_Get_Advance``, no
        hinting): 16.16 pixels rounded to 26.6."""
        v = (int(self.advances[gid]) * scale + 32) // 64
        return (v + (1 << 9)) >> 10


class GlyphOutline(NamedTuple):
    """A loaded glyph: points (N, 2) int64 (26.6 px, or font units), y up;
    on-curve flags (N,) bool; the contours' last point indices; whether
    the glyph is flagged OVERLAP_SIMPLE or OVERLAP_COMPOUND (FreeType then
    rasterizes it oversampled)."""

    points: np.ndarray
    on: np.ndarray
    ends: List[int]
    overlap: bool


class _Outline:
    """The points loaded so far (FreeType's glyph loader's base)."""

    __slots__ = ("x", "y", "on", "ends", "overlap")

    def __init__(self):
        self.overlap = False
        self.x: List[int] = []
        self.y: List[int] = []
        self.on: List[bool] = []
        self.ends: List[int] = []


@functools.lru_cache(maxsize=32)
def load_face(path: str) -> TrueTypeFace:
    """The parsed face of ``path``, parsed once a process."""
    return TrueTypeFace(path)
