"""The port's TrueType reader and shaper (``marconet_tpu_torch/utils/
truetype.py``) on the fixture font ``tests/data/fonts/DejaVuSans.ttf``
(DejaVu Sans, the JAX package's fallback font), with fontTools and PIL as
oracles.

* Reader, against ``fontTools.ttLib.TTFont``: the header metrics, the
  glyph of every character of the model's alphabet, every advance and
  left side bearing, and the outline (points, on-curve flags, contour
  ends) of every glyph the alphabet reaches through the character map
  and the ligatures, composites included; exact.
* Script property, against ``fontTools.unicodedata.script``, for every
  character of the alphabet and of printable ASCII; exact.
* Shaping, against PIL's RAQM ``getlength`` (libraqm + HarfBuzz): every
  single character of the alphabet, every pair of its ASCII characters
  (kerning and the ``f`` ligatures), and 200 seeded strings mixing Han,
  Latin and the alphabet's other characters, within 1/64 px (the unit of
  both layouts, so in effect exact).
"""

import numpy as np
import pytest
from fontTools import unicodedata
from fontTools.ttLib import TTFont
from PIL import ImageFont

from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.utils import truetype
from marconet_tpu_torch.utils.text_draw import truetype as load_font

FONT = "tests/data/fonts/DejaVuSans.ttf"
SIZES = (90, 115, 140)
ASCII = [c for c in alphabet() if ord(c) < 128]


@pytest.fixture(scope="module")
def face():
    return truetype.TrueTypeFace(FONT)


@pytest.fixture(scope="module")
def oracle():
    return TTFont(FONT)


def test_header_metrics_match_fonttools(face, oracle):
    assert face.units_per_em == oracle["head"].unitsPerEm
    assert face.index_to_loc == oracle["head"].indexToLocFormat
    assert (face.ascender, face.descender) == (oracle["hhea"].ascent,
                                               oracle["hhea"].descent)
    assert face.num_glyphs == oracle["maxp"].numGlyphs


def test_cmap_matches_fonttools(face, oracle):
    """Every alphabet character maps to fontTools' glyph, a missing one
    (most of the Han characters) to 0."""
    best = oracle.getBestCmap()
    want = [oracle.getGlyphID(best[ord(c)]) if ord(c) in best else 0
            for c in alphabet()]
    got = [face.glyph_index(c) for c in alphabet()]
    assert got == want
    assert sum(g != 0 for g in got) == 176
    # the whole (3, 10) table, beyond the alphabet
    assert {cp: oracle.getGlyphID(name) for cp, name in best.items()} == \
        face.cmap


def test_advances_match_fonttools(face, oracle):
    hmtx = oracle["hmtx"]
    names = oracle.getGlyphOrder()
    assert face.advances.tolist() == [hmtx[n][0] for n in names]
    assert face.lsb.tolist() == [hmtx[n][1] for n in names]


def _reached_glyphs(face):
    """The glyphs the alphabet reaches: its characters', .notdef, the
    space and the ligatures shaping forms from its ASCII pairs."""
    glyphs = {face.glyph_index(c) for c in alphabet()} | {0,
                                                          face.space_glyph}
    for a in ASCII:
        for b in ASCII:
            glyphs.update(face.shape(a + b, 100)[0])
    for text in ("ffi", "ffl"):
        glyphs.update(face.shape(text, 100)[0])
    return sorted(glyphs)


def test_outlines_match_fonttools(face, oracle):
    glyf = oracle["glyf"]
    names = oracle.getGlyphOrder()
    reached = _reached_glyphs(face)
    composites = 0
    for gid in reached:
        g = glyf[names[gid]]
        coords, ends, flags = g.getCoordinates(glyf)
        pts, on, got_ends = face.outline(gid)
        want = np.rint(np.asarray(coords, np.float64).reshape(-1, 2))
        np.testing.assert_array_equal(pts, want, names[gid])
        assert on.tolist() == [bool(f & 1) for f in flags], names[gid]
        assert got_ends == list(ends), names[gid]
        assert face.x_min(gid) == getattr(g, "xMin", 0), names[gid]
        composites += g.isComposite()
    assert len(reached) > 180 and composites >= 5


def test_scripts_match_unicode_data():
    for c in list(alphabet()) + [chr(i) for i in range(32, 127)]:
        want = unicodedata.script(c)
        assert truetype.script(c) == (want if want in (
            "Latn", "Grek", "Cyrl", "Hani", "Hira", "Kana", "Bopo", "Zinh")
            else "Zyyy"), (c, hex(ord(c)), want)


def test_script_runs_follow_libraqm():
    runs = truetype.script_runs
    # a leading Common run joins the run after it, a later one the run
    # before it
    assert runs("12中a.") == [(0, 3, "Hani"), (3, 5, "Latn")]
    # a closing bracket takes its opening bracket's script
    assert runs("a(中)b") == [(0, 2, "Latn"), (2, 3, "Hani"),
                              (3, 5, "Latn")]
    assert runs("") == [] and runs("..") == [(0, 2, "Zyyy")]


@pytest.mark.parametrize("size", SIZES)
def test_single_characters_match_pil(size):
    pil = ImageFont.truetype(FONT, size)
    font = load_font(FONT, size)
    bad = [c for c in alphabet() if font.getlength(c) != pil.getlength(c)]
    assert not bad, bad[:20]


@pytest.mark.parametrize("size", (97, 128))
def test_ascii_pairs_match_pil(size):
    """Kerning (GPOS pair adjustment) and the f ligatures (GSUB)."""
    pil = ImageFont.truetype(FONT, size)
    font = load_font(FONT, size)
    pairs = [a + b for a in ASCII for b in ASCII]
    bad = [p for p in pairs if font.getlength(p) != pil.getlength(p)]
    assert not bad, bad[:20]
    kerned = [p for p in pairs if pil.getlength(p) !=
              pil.getlength(p[0]) + pil.getlength(p[1])]
    assert len(kerned) > 200            # the pairs do reach GPOS and GSUB
    assert font.face.shape("fi", size)[0] == \
        [font.face.cmap[0xFB01]]


@pytest.mark.parametrize("size", SIZES)
def test_mixed_strings_match_pil(size):
    """200 seeded strings of 2-16 characters, each drawn from all of the
    alphabet or from its non-Han part (Latin, digits, punctuation,
    fullwidth forms, Greek, Cyrillic, kana, symbols)."""
    chars = alphabet()
    other = [c for c in chars if truetype.script(c) != "Hani"]
    rng = np.random.default_rng(size)
    pil = ImageFont.truetype(FONT, size)
    font = load_font(FONT, size)
    bad = []
    for _ in range(200):
        k = int(rng.integers(2, 17))
        text = "".join(chars[rng.integers(len(chars))] if rng.random() < 0.5
                       else other[rng.integers(len(other))]
                       for _ in range(k))
        if font.getlength(text) != pil.getlength(text):
            bad.append(text)
    assert not bad, bad[:10]


def test_metrics_match_pil():
    """The ascender and descender in whole pixels at every size the
    synthesizer draws."""
    for size in range(90, 141):
        assert load_font(FONT, size).getmetrics() == \
            ImageFont.truetype(FONT, size).getmetrics(), size


def test_a_file_that_is_no_font_is_named(tmp_path):
    path = tmp_path / "notes.txt"
    path.write_text("not a font\n")
    with pytest.raises(truetype.FontError, match="notes.txt"):
        truetype.TrueTypeFace(str(path))
