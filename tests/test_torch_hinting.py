"""The port's TrueType hinting (``marconet_tpu_torch/utils/ttinterp.py``,
the glyph loader of ``utils/truetype.py``) and its rasterizer
(``utils/raster.py``) against Pillow's own FreeType 2.14.1, called through
``ctypes`` (``tests/freetype_oracle.py``), on the fixture font
``tests/data/fonts/DejaVuSans.ttf`` and on small fonts built in memory
(``tests/truetype_programs.py``, fontTools in the tests only).

* The interpreter by instruction family, on hand-made zones, with values
  worked from the OpenType specification (and FreeType's rounding where
  the specification leaves it open): stack and arithmetic, the rounding
  states, flow, vectors, MDRP / MIRP, IP / ISECT / IUP, DELTAP and the
  v40 backward-compatibility rules.
* Every glyph the model's alphabet reaches (177, ``.notdef`` included)
  at 32, 90, 115 and 140 px: hinted points, tags and contours equal
  FreeType's ``FT_LOAD_DEFAULT`` load exactly; unhinted points equal its
  ``FT_LOAD_NO_HINTING`` load (the composites too); the bitmap of FreeType's
  own points equals FreeType's; the port's ``getmask`` inks what PIL's
  does.
* In-memory fonts: each family of :data:`truetype_programs.PROGRAMS`
  (the whole instruction set, undefined opcodes and errors included),
  MDRP and MIRP with all 32 flag combinations, composites (offsets,
  matched points, scales, 2 x 2 transforms, USE_MY_METRICS, their own
  programs), what ``prep`` leaves the glyph programs, OVERLAP flags; with
  backward compatibility on and off; equal to FreeType's points exactly.
* The digest fixture ``tests/data/DejaVuSans.hinted.json`` (what the
  card's host, without PIL, checks the port against) equals PIL's masks.
"""

import io
import json
import os

import numpy as np
import pytest
from fontTools.ttLib import TTFont
from PIL import Image, ImageDraw, ImageFont

from marconet_tpu_torch.utils import raster, text_draw, ttinterp
from marconet_tpu_torch.utils.truetype import FontError, TrueTypeFace
from tests import torch_render_report as report
from tests import truetype_programs as tp
from tests.freetype_oracle import Face

FONT = report.FONT
SIZES = (32, 90, 115, 140)
PROBE_SIZES = (9, 11, 17, 24, 37)


# -- the interpreter on hand-made zones ---------------------------------------

SQUARE = ((0, 0), (0, 640), (640, 640), (640, 0))


def run(tokens, points=SQUARE, *, cvt=(), fpgm=(), compat=False,
        ppem=20, contours=None):
    """Run ``tokens`` as a glyph program on a one-contour zone of
    ``points`` (26.6, also its unscaled coordinates: the scale is 1.0);
    the interpreter and the zone after it."""
    hint = ttinterp.FontHinting(
        cvt=list(cvt), fpgm=tp.assemble(fpgm), prep=b"", max_stack=64,
        max_storage=8, max_twilight=4, max_fdefs=8, max_idefs=2)
    state = hint.size(ppem, 0x10000)
    n = len(points)
    zone = ttinterp.Zone(n + 4, contours or [n - 1])
    for i, (x, y) in enumerate(points):
        zone.cx[i] = zone.ux[i] = x
        zone.cy[i] = zone.uy[i] = y
    hint.e.backward_compatibility = compat
    hint.hint(state, zone, ttinterp.Program(tp.assemble(tokens)), False)
    return hint.e, zone


def stack(tokens, **kw):
    e, _ = run(tokens, **kw)
    return e.stack[:e.top]


def test_stack_and_arithmetic():
    # 26.6: MUL is a * b / 64 rounded half away from zero, DIV a * 64 / b
    # truncated, FLOOR / CEILING to whole pixels
    assert stack([160, 96, "MUL", 32, 1, "MUL", -32, 1, "MUL"]) == \
        [240, 1, -1]                        # 2.5 x 1.5; +-0.5/64 -> +-1
    assert stack([64, 192, "DIV", -64, 192, "DIV"]) == [21, -21]
    assert stack([-1, "FLOOR", -65, "CEILING", 65, "CEILING"]) == \
        [-64, -64, 128]
    assert stack([-100, "ABS", 30, "NEG", 300, -7, "MAX", 20, 50, "MIN",
                  7, 5, "SUB", 2, 3, "ADD"]) == [100, -30, 300, 20, 2, 5]
    assert stack([3, 5, "LT", 5, 5, "LTEQ", 5, 6, "GT", 7, 5, "GTEQ",
                  4, 4, "EQ", 4, 9, "NEQ", 1, 0, "AND", 1, 0, "OR",
                  0, "NOT"]) == [1, 1, 0, 1, 1, 1, 0, 1, 1]
    # DUP, SWAP, POP, ROLL (a b c -> b c a), DEPTH, CINDEX, MINDEX, CLEAR
    assert stack([7, "DUP", 1, 2, "SWAP", "POP"]) == [7, 7, 2]
    assert stack([1, 2, 3, "ROLL"]) == [2, 3, 1]
    assert stack([10, 20, 30, "DEPTH"]) == [10, 20, 30, 3]
    assert stack([10, 20, 30, 3, "CINDEX"]) == [10, 20, 30, 10]
    assert stack([10, 20, 30, 3, "MINDEX"]) == [20, 30, 10]
    assert stack([10, 20, "CLEAR", 5]) == [5]


def test_an_error_stops_the_program():
    # division by zero: the program stops before DIV's result and the
    # 7; a read past the stack's bottom takes zeros and goes on
    assert stack([5, 64, 0, "DIV", 7]) == [5, 64, 0]
    assert stack(["ADD", 9]) == [0, 9]
    assert stack([1, b"\x28", 2]) == [1]            # undefined opcode


@pytest.mark.parametrize("state, cases", [
    (["RTG"], ((95, 64), (96, 128), (-96, -128), (-95, -64), (0, 0))),
    (["RTHG"], ((0, 32), (70, 96), (-1, -32), (64, 96))),
    (["RTDG"], ((47, 32), (48, 64), (15, 0), (16, 32))),
    (["RDTG"], ((127, 64), (-127, -64), (63, 0))),
    (["RUTG"], ((1, 64), (-1, -64), (64, 64))),
    (["ROFF"], ((37, 37), (-5, -5))),
    # period 1 px, phase 1/4 px, threshold 1/2 px: x.25 pixel centres
    ([0x58, "SROUND"], ((100, 80), (130, 144), (0, 16), (-100, -80))),
    # period sqrt(2)/2 px, phase 0, threshold period - 1; both cut to
    # 1/64 px (11585 / 256, 11584 / 256) are 45, so 0 rounds up to 45
    ([0x40, "S45ROUND"], ((100, 135), (67, 90), (0, 45), (-1, -45))),
])
def test_rounding_states(state, cases):
    tokens = list(state)
    for value, _ in cases:
        tokens += [value, "ROUND[00]"]
    assert stack(tokens) == [want for _, want in cases]


def test_odd_and_even_test_the_rounded_floor():
    # ODD / EVEN round in the current state and look at the whole pixels
    # of the result: under RTHG 70 -> 96, 1.5 px, odd
    assert stack([64, "ODD", 96, "ODD", 96, "EVEN"]) == [1, 0, 1]
    assert stack(["RTHG", 70, "ODD", -128, "ODD", -64, "EVEN"]) == \
        [1, 1, 1]


def test_flow():
    fpgm = [0, "FDEF", 64, "ADD", "ENDF", 1, "FDEF", 0, "CALL", "ENDF"]
    assert stack([1, "IF", 100, "ELSE", 200, "EIF"]) == [100]
    assert stack([0, "IF", 100, "ELSE", 1, "IF", 300, "ELSE", 400, "EIF",
                  "EIF"]) == [300]
    # a jump's offset counts bytes from the jump: PUSHB[0] 66 is two
    assert stack([77, 3, "JMPR", b"\xb0\x42", 99]) == [77, 99]
    assert stack([10, 3, 1, "JROT", b"\xb0\x14", b"\xb0\x1e"]) == [10, 30]
    assert stack([10, 3, 1, "JROF", b"\xb0\x14", b"\xb0\x1e"]) == \
        [10, 20, 30]
    assert stack([10, 3, 0, "JROF", b"\xb0\x14", b"\xb0\x1e"]) == [10, 30]
    assert stack([5, 1, "CALL"], fpgm=fpgm) == [69]
    assert stack([5, 3, 0, "LOOPCALL"], fpgm=fpgm) == [197]
    # a negative jump loops: 3 passes of "add 64, count down"
    assert stack([0, 3, "SWAP", 64, "ADD", "SWAP", 1, "SUB", "DUP", -13,
                  "SWAP", "JROT", "POP"]) == [192]


def test_vectors_are_unit_f2dot14():
    # (1, 1) / sqrt(2) = 0.70710678 -> 11585 / 16384; (3, 4) / 5 ->
    # (9830, 13107); [1] turns the line a quarter counter-clockwise
    pts = ((0, 0), (640, 640), (192, 256), (0, 64))
    assert stack([1, 0, "SPVTL[0]", "GPV"], points=pts) == [11585, 11585]
    assert stack([1, 0, "SPVTL[1]", "GPV"], points=pts) == [-11585, 11585]
    assert stack([2, 0, "SFVTL[0]", "GFV"], points=pts) == [9830, 13107]
    assert stack([3, -4, "SPVFS", "GPV"]) == [9830, -13107]
    assert stack([3, 0, "SDPVTL[0]", "GPV", 0, "SVTCA[1]", "SFVTPV",
                  "GFV"], points=pts) == [0, 16384, 0, 16384, 0]
    # a line of length 0 is the x axis
    assert stack([1, 1, "SPVTL[0]", "GPV"], points=pts) == [16384, 0]


def _y(tokens, **kw):
    return run(["SVTCA[0]", *tokens], **kw)[1].cy


def test_mdrp_flags():
    pts = ((0, 0), (0, 10), (0, 100), (0, -100))
    # no flags: the original distance; [00100] rounds it; [01000] keeps
    # the minimum distance (1 px); [01100] both
    assert _y([1, "MDRP[00000]"], points=pts)[1] == 10
    assert _y([1, "MDRP[00100]"], points=pts)[1] == 0
    assert _y([1, "MDRP[01000]"], points=pts)[1] == 64
    assert _y([2, "MDRP[00100]"], points=pts)[2] == 128
    assert _y([3, "MDRP[01100]"], points=pts)[3] == -128
    # [10000] makes the point rp0: the second MDRP measures from it
    assert _y([1, "MDRP[11000]", 2, "MDRP[00100]"], points=pts)[2] == 64 + 64


def test_mirp_cut_in_and_auto_flip():
    pts = ((0, 0), (0, 100), (0, -100))
    cvt = [128, 300]
    # |cvt - original| = 28 <= 68 (17/16 px): the cvt, rounded
    assert _y([1, 0, "MIRP[00100]"], points=pts, cvt=cvt)[1] == 128
    # 200 > 68: the original distance, rounded
    assert _y([1, 1, "MIRP[00100]"], points=pts, cvt=cvt)[1] == 128
    # no round: the cvt as it is; auto-flip follows the original's sign
    assert _y([2, 0, "MIRP[00000]"], points=pts, cvt=cvt)[2] == -128
    assert _y(["FLIPOFF", 2, 0, "MIRP[00000]"], points=pts,
              cvt=cvt)[2] == 128
    # cvt entry -1 is 0; the minimum distance then holds it at 1 px
    assert _y([1, -1, "MIRP[01000]"], points=pts, cvt=cvt)[1] == 64


def test_ip_isect_iup():
    pts = ((0, 0), (0, 100), (0, 50), (0, 25))
    # rp1 at 0, rp2 moved from 100 to 200: 50 goes to 100
    y = _y([0, "SRP1", 1, 200, "SCFS", 1, "SRP2", 2, "IP"], points=pts)
    assert (y[1], y[2]) == (200, 100)
    # the diagonals of a 128 square cross at (64, 64)
    pts = ((0, 0), (128, 128), (0, 128), (128, 0), (7, 7))
    e, z = run([4, 0, 1, 2, 3, "ISECT"], points=pts)
    assert (z.cx[4], z.cy[4]) == (64, 64)
    # IUP[y]: points between two moved ones are interpolated by their
    # unscaled place, those outside shifted with the nearer
    pts = ((0, 0), (0, 30), (0, 60), (0, 90), (0, 120))
    y = _y([0, 10, "SCFS", 2, 90, "SCFS", "IUP[0]"], points=pts)
    assert y[:5] == [10, 50, 90, 120, 150]


def test_deltap():
    # (argument, point) pairs under their count; ppem 20 = delta base 9
    # + 11: 0xB_ selects it; low nibble 10 is +3 steps of 1/8 px (delta
    # shift 3): 24
    pts = ((0, 0), (0, 100))
    assert _y([0xBA, 1, 1, "DELTAP1"], points=pts)[1] == 124
    assert _y([0xAA, 1, 1, "DELTAP1"], points=pts)[1] == 100   # ppem 19
    # base 20, nibble 5 = -3 steps
    assert _y([20, "SDB", 0x05, 1, 1, "DELTAP1"], points=pts)[1] == 76
    # backward compatibility: only a point touched in y moves
    assert _y([0xBA, 1, 1, "DELTAP1"], points=pts, compat=True)[1] == 100
    assert _y([1, "MDAP[0]", 0xBA, 1, 1, "DELTAP1"], points=pts,
              compat=True)[1] == 124


def test_backward_compatibility():
    pts = ((10, 10), (300, 300))
    # x moves are dropped but the point is touched in x
    e, z = run(["SVTCA[1]", 0, "MDAP[1]"], points=pts, compat=True)
    assert z.cx[0] == 10 and z.tags[0] & ttinterp.TOUCH_X
    e, z = run(["SVTCA[1]", 0, "MDAP[1]"], points=pts)
    assert z.cx[0] == 0
    # after IUP[x] and IUP[y] nothing moves; ISECT still moves x
    e, z = run(["IUP[0]", "IUP[1]", "SVTCA[0]", 0, "MDAP[1]"], points=pts,
               compat=True)
    assert z.cy[0] == 10
    e, z = run([1, 0, 1, 0, 1, "ISECT"],
               points=((0, 0), (128, 128), (5, 5)), compat=True)
    assert (z.cx[1], z.cy[1]) == (64, 64)


# -- DejaVu Sans against FreeType ---------------------------------------------


@pytest.fixture(scope="module")
def dejavu():
    face = TrueTypeFace(FONT)
    return face, Face(FONT), report.alphabet_glyphs(face)


@pytest.mark.parametrize("size", SIZES)
def test_hinted_points_match_freetype(dejavu, size):
    face, oracle, glyphs = dejavu
    assert len(glyphs) == 177
    moved = 0
    for gid, ch in glyphs:
        want = oracle.load(gid, size)
        got = face.hinted_outline(gid, size)
        np.testing.assert_array_equal(got.points, want.points, repr(ch))
        assert got.on.tolist() == (want.tags & 1).astype(bool).tolist()
        assert got.ends == want.ends
        moved += (want.points != oracle.load(gid, size, False).points).any()
    assert moved > 140                      # hinting does move them


@pytest.mark.parametrize("size", SIZES)
def test_unhinted_points_match_freetype(dejavu, size):
    face, oracle, glyphs = dejavu
    composites = 0
    for gid, ch in glyphs:
        want = oracle.load(gid, size, hinted=False)
        got = face.load(gid, size, hinted=False)
        np.testing.assert_array_equal(got.points, want.points, repr(ch))
        composites += face._record(gid) is not None and \
            not face._record(gid)[1]
    assert composites == 21


@pytest.mark.parametrize("size", SIZES)
def test_raster_matches_freetype_on_its_points(dejavu, size):
    """The rasterizer alone: FreeType's own hinted points through
    ``raster.render`` give FreeType's bitmap."""
    _, oracle, glyphs = dejavu
    for gid, ch in glyphs:
        g = oracle.load(gid, size)
        cov, left, top = oracle.bitmap(gid, size)
        bm = raster.render(g.points, (g.tags & 1).astype(bool), g.ends)
        np.testing.assert_array_equal(bm.coverage, cov, repr(ch))
        if cov.size:
            assert (bm.left, bm.top) == (left, top), ch


@pytest.mark.parametrize("size", SIZES)
def test_masks_match_pil(dejavu, size):
    """The port's ``getmask`` inks what PIL's ``getmask2`` inks, glyph by
    glyph (PIL frames the ink from the pen position, the port tightly)."""
    chars = "".join(ch for _, ch in dejavu[2])
    pil = report.pillow_digests(chars, (size,))[str(size)]
    port = report.port_digests(chars, (size,))[str(size)]
    assert [c for c, a, b in zip(chars, pil, port) if a != b] == []


def test_digest_fixture_matches_pil():
    with open(report.DIGESTS) as f:
        fixture = json.load(f)
    chars = fixture["chars"]
    assert len(chars) == 177
    assert report.pillow_digests(chars) == fixture["digests"]


# -- in-memory fonts against FreeType -----------------------------------------


def _faces(data: bytes, tmp_path, name="probe.ttf"):
    path = tmp_path / name
    path.write_bytes(data)
    return TrueTypeFace(str(path)), Face(data)


def _compare(data, tmp_path, glyphs, sizes=PROBE_SIZES, hinted=True):
    face, oracle = _faces(data, tmp_path)
    parted = []
    for size in sizes:
        for gid in glyphs:
            want = oracle.load(gid, size, hinted)
            got = face.load(gid, size, hinted)
            if got.points.shape != want.points.shape or \
                    (got.points != want.points).any() or \
                    got.on.tolist() != (want.tags & 1).astype(bool).tolist():
                parted.append((size, gid, want.points.tolist(),
                               got.points.tolist()))
    return parted


@pytest.mark.parametrize("family", sorted(tp.PROGRAMS))
def test_programs_match_freetype(family, tmp_path):
    for prep in ((0, "POP"), tp.PREP_NO_COMPAT):
        data = tp.build_font([tp.PROGRAMS[family]], prep=prep)
        assert _compare(data, tmp_path, [1]) == [], (family, prep)


@pytest.mark.parametrize("op", ["MDRP", "MIRP"])
def test_all_flag_combinations_match_freetype(op, tmp_path):
    progs = tp.MDRP_FLAGS if op == "MDRP" else tp.MIRP_FLAGS
    for prep in ((0, "POP"), tp.PREP_NO_COMPAT):
        data = tp.build_font(progs, prep=prep)
        assert _compare(data, tmp_path, range(1, 33), (11, 24)) == []


SHPIX_LOOP = ["SVTCA[0]", 1, 3, 9, 45, 3, "SLOOP", "SHPIX", 0, "MDAP[1]",
              "IUP[0]", "IUP[1]"]
MOVE_SOME = ["SVTCA[0]", 0, "MDAP[1]", 2, "MDRP[11100]", 5, "MDRP[10100]",
             "IUP[0]", "IUP[1]"]
COMPOSITES = [
    {"components": [(1, 0x6, 0, 0, None), (2, 0x6, 417, 33, None)]},
    {"components": [(1, 0x206, 10, -17, None), (2, 0x2, 300, 41, None)],
     "program": SHPIX_LOOP},
    {"components": [(1, 0x2, 0, 0, None), (2, 0x0, 3, 5, None)],
     "program": MOVE_SOME},
    {"components": [(1, 0xA, 13, 29, [[0.75, 0], [0, 0.75]]),
                    (2, 0x842, 250, 60, [[1.25, 0], [0, 0.5]])]},
    {"components": [(2, 0x882, 120, -40, [[0.8, 0.3], [-0.2, 0.9]]),
                    (1, 0x86, 77, 55, [[0.5, 0.5], [-0.5, 0.5]])],
     "program": SHPIX_LOOP},
    {"components": [(5, 0x206, 31, 11, None), (1, 0x2, 500, 0, None)],
     "program": MOVE_SOME},
]


@pytest.mark.parametrize("lsb_shift", [0, 37])
def test_composites_match_freetype(lsb_shift, tmp_path):
    """Component offsets (rounded in y, and in x without backward
    compatibility), matched points, scales and 2 x 2 transforms with
    scaled offsets, USE_MY_METRICS, a composite of a composite, the
    composites' own programs; a left side bearing off ``xMin``."""
    progs = [tp.PROGRAMS["ip_shp"], tp.PROGRAMS["delta_p"],
             tp.PROGRAMS["twilight"]]
    glyphs = range(1, len(progs) + len(COMPOSITES) + 1)
    for prep in ((0, "POP"), tp.PREP_NO_COMPAT):
        data = tp.build_font(progs, composites=COMPOSITES, prep=prep,
                             lsb_shift=lsb_shift)
        assert _compare(data, tmp_path, glyphs) == []
        assert _compare(data, tmp_path, glyphs, hinted=False) == []


USE_STATE = [*tp.record(0, 70, "ROUND[00]"), "SVTCA[0]", 1, "MDRP[01100]",
             2, 3, "MIRP[10100]", 4, "MDRP[11000]",
             *tp.record(5, 0, "GFV", "ADD")]
READ_STATE = [*tp.record(0, 3, "RCVT"), *tp.record(1, 4, "RS"),
              *tp.record(2, 0, "SZP0", 1, "SZP1", 3, 5, "MD[1]"), 1, "SZPS",
              "IUP[0]"]
SET_STATE = [3, 77, "WCVTP", 4, 66, "WS", 0, "SZP0", "SVTCA[0]", 3, 7,
             "MIAP[0]", 5, 9, "MIAP[1]"]


@pytest.mark.parametrize("prep, programs", [
    # the graphics state prep leaves (its round state does not reach the
    # glyphs: they start at RTG)
    (["RTHG", 100, "SMD", 10, "SCVTCI", 50, "SSW", 30, "SSWCI", 15, "SDB",
      2, "SDS", "FLIPOFF", "SVTCA[1]", 0x62, "SROUND"],
     [USE_STATE, tp.PROGRAMS["delta_p"], tp.PROGRAMS["mirp_cutin"]]),
    # its CVT, storage and twilight zone
    (SET_STATE, [READ_STATE]),
    # INSTCTRL: hinting off; the default graphics state for glyphs
    ([1, 1, "INSTCTRL"], [tp.PROGRAMS["ip_shp"]]),
    (["RTHG", 100, "SMD", 2, 2, "INSTCTRL"], [USE_STATE]),
    # functions defined by size
    (["MPPEM", 15, "GT", "IF", 9, "FDEF", 200, "ENDF", "ELSE", 9, "FDEF",
      100, "ENDF", "EIF"], [tp.record(0, 9, "CALL")]),
], ids=["graphics_state", "cvt_storage_twilight", "instctrl_off",
        "instctrl_default", "fdef_by_size"])
def test_prep_state_reaches_glyphs(prep, programs, tmp_path):
    data = tp.build_font(programs, prep=prep)
    assert _compare(data, tmp_path, range(1, len(programs) + 1)) == []


def test_glyph_cvt_and_storage_writes_stay_in_the_glyph(tmp_path):
    """FreeType runs a glyph program on copies of the CVT and the
    storage: a write does not reach the next glyph."""
    writes = [3, 999, "WCVTP", 4, 555, "WS"]
    reads = [*tp.record(0, 3, "RCVT"), *tp.record(1, 4, "RS")]
    data = tp.build_font([writes, reads], prep=SET_STATE)
    face, oracle = _faces(data, tmp_path)
    for gid in (1, 2, 2):
        np.testing.assert_array_equal(face.load(gid, 11).points,
                                      oracle.load(gid, 11).points)
    assert face.load(2, 11).points[:2, 1].tolist() == [77, 66]


def test_undefined_opcode_matches_pillow(tmp_path):
    """A glyph program with an opcode the specification leaves undefined
    and no IDEF defines: FreeType (not pedantic) stops the program there
    and keeps the glyph as far as it got; an IDEF'd one runs its
    definition. Points against FreeType, pixels against PIL."""
    data = tp.build_font([tp.PROGRAMS["idef_and_undefined"],
                          tp.PROGRAMS["ip_shp"]])
    assert _compare(data, tmp_path, [1, 2]) == []
    path = str(tmp_path / "probe.ttf")
    for size in (11, 24, 37):
        pil = ImageFont.truetype(io.BytesIO(data), size)
        want = Image.new("L", (200, 80))
        ImageDraw.Draw(want).text((5, 3), "AB", font=pil, fill=255)
        got = np.zeros((80, 200), np.uint8)
        text_draw.draw_text(got, (5, 3), "AB", text_draw.truetype(path, size),
                            255)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_a_failing_prep_fails_like_freetype(tmp_path):
    """FreeType refuses to load a glyph when ``prep`` stops on an error
    (PIL then raises); so does the port."""
    data = tp.build_font([[]], prep=[b"\x28", 5, "SMD"])
    face, oracle = _faces(data, tmp_path)
    with pytest.raises(RuntimeError, match="FT_Load_Glyph"):
        oracle.load(1, 11)
    with pytest.raises(FontError, match="Invalid_Opcode"):
        face.load(1, 11)


@pytest.mark.parametrize("first_flags", [0x402, 0x2])
def test_overlap_glyphs_match_freetype(first_flags, tmp_path):
    """OVERLAP_SIMPLE on a simple glyph, OVERLAP_COMPOUND on a composite's
    first component: FreeType rasterizes them oversampled 4 x 4."""
    comps = [{"components": [(2, first_flags, 0, 0, None),
                             (2, 0x402, 200, 100, None)]}]
    font = TTFont(io.BytesIO(tp.build_font([tp.PROGRAMS["ip_shp"], []],
                                           composites=comps)))
    simple = font["glyf"]["g0"]
    simple.expand(font["glyf"])
    simple.flags[0] |= 0x40
    buf = io.BytesIO()
    font.save(buf)
    face, oracle = _faces(buf.getvalue(), tmp_path)
    overlapped = {1: True, 2: False, 3: first_flags == 0x402}
    for gid, flagged in overlapped.items():
        assert face.load(gid, 11).overlap == flagged
        for size in (11, 24, 57):
            cov, left, top = oracle.bitmap(gid, size)
            bm = raster.glyph_bitmap(face, size, gid)
            np.testing.assert_array_equal(bm.coverage, cov, (gid, size))
            assert (bm.left, bm.top) == (left, top)


def test_fixture_files_are_small():
    assert os.path.getsize(report.DIGESTS) < 60_000
