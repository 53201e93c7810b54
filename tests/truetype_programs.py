"""Small TrueType fonts built in memory with fontTools, whose glyph
programs exercise the bytecode interpreter instruction by instruction;
``tests/test_torch_hinting.py`` loads each glyph with the port and with
Pillow's FreeType (``tests/freetype_oracle.py``) and compares the points.

Every glyph has the outline of :data:`OUTLINE` (two contours, eight
points, an arc) and one program. A program makes its results visible in
the points: values it computes are written into point coordinates with
SCFS along y (``record``), and moves act on the points themselves. A
font has an ``fpgm`` (FreeType auto-hints a font without one, which is
not the bytecode interpreter) holding the functions of :data:`FPGM`.
"""

from __future__ import annotations

import array
import io
from typing import Dict, List, Sequence

from fontTools.fontBuilder import FontBuilder
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import newTable
from fontTools.ttLib.tables import ttProgram
from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent

UPEM = 1000
# contour 0: points 0-4 (an arc through 2), contour 1: points 5-7
OUTLINE = (((103, 13), (97, 517), ("q", 181, 713), (377, 709), (421, 403)),
           ((211, 201), (233, 389), (319, 305)))
CVT = [0, 64, 300, 517, 20, -40, 1000, 90, 33, 700]

# function 0: records (point, value) pairs along y; 1: adds 64 to the
# top of the stack; 2: recursion one deep; 3: a function LOOPCALL runs
FPGM = [0, "FDEF", "SVTCA[0]", "SWAP", "SCFS", "ENDF",
        1, "FDEF", 64, "ADD", "ENDF",
        2, "FDEF", 1, "CALL", "ENDF",
        3, "FDEF", 7, "RS", 64, "ADD", 7, "SWAP", "WS", "ENDF",
        0x91, "IDEF", 5, "MUL", "ENDF"]


_OPCODES = {
    "SVTCA": 0x00, "SPVTCA": 0x02, "SFVTCA": 0x04, "SPVTL": 0x06,
    "SFVTL": 0x08, "SPVFS": 0x0A, "SFVFS": 0x0B, "GPV": 0x0C, "GFV": 0x0D,
    "SFVTPV": 0x0E, "ISECT": 0x0F, "SRP0": 0x10, "SRP1": 0x11,
    "SRP2": 0x12, "SZP0": 0x13, "SZP1": 0x14, "SZP2": 0x15, "SZPS": 0x16,
    "SLOOP": 0x17, "RTG": 0x18, "RTHG": 0x19, "SMD": 0x1A, "ELSE": 0x1B,
    "JMPR": 0x1C, "SCVTCI": 0x1D, "SSWCI": 0x1E, "SSW": 0x1F, "DUP": 0x20,
    "POP": 0x21, "CLEAR": 0x22, "SWAP": 0x23, "DEPTH": 0x24,
    "CINDEX": 0x25, "MINDEX": 0x26, "ALIGNPTS": 0x27, "UTP": 0x29,
    "LOOPCALL": 0x2A, "CALL": 0x2B, "FDEF": 0x2C, "ENDF": 0x2D,
    "MDAP": 0x2E, "IUP": 0x30, "SHP": 0x32, "SHC": 0x34, "SHZ": 0x36,
    "SHPIX": 0x38, "IP": 0x39, "MSIRP": 0x3A, "ALIGNRP": 0x3C,
    "RTDG": 0x3D, "MIAP": 0x3E, "WS": 0x42, "RS": 0x43, "WCVTP": 0x44,
    "RCVT": 0x45, "GC": 0x46, "SCFS": 0x48, "MD": 0x49, "MPPEM": 0x4B,
    "MPS": 0x4C, "FLIPON": 0x4D, "FLIPOFF": 0x4E, "DEBUG": 0x4F,
    "LT": 0x50, "LTEQ": 0x51, "GT": 0x52, "GTEQ": 0x53, "EQ": 0x54,
    "NEQ": 0x55, "ODD": 0x56, "EVEN": 0x57, "IF": 0x58, "EIF": 0x59,
    "AND": 0x5A, "OR": 0x5B, "NOT": 0x5C, "DELTAP1": 0x5D, "SDB": 0x5E,
    "SDS": 0x5F, "ADD": 0x60, "SUB": 0x61, "DIV": 0x62, "MUL": 0x63,
    "ABS": 0x64, "NEG": 0x65, "FLOOR": 0x66, "CEILING": 0x67,
    "ROUND": 0x68, "NROUND": 0x6C, "WCVTF": 0x70, "DELTAP2": 0x71,
    "DELTAP3": 0x72, "DELTAC1": 0x73, "DELTAC2": 0x74, "DELTAC3": 0x75,
    "SROUND": 0x76, "S45ROUND": 0x77, "JROT": 0x78, "JROF": 0x79,
    "ROFF": 0x7A, "RUTG": 0x7C, "RDTG": 0x7D, "SANGW": 0x7E, "AA": 0x7F,
    "FLIPPT": 0x80, "FLIPRGON": 0x81, "FLIPRGOFF": 0x82,
    "SCANCTRL": 0x85, "SDPVTL": 0x86, "GETINFO": 0x88, "IDEF": 0x89,
    "ROLL": 0x8A, "MAX": 0x8B, "MIN": 0x8C, "SCANTYPE": 0x8D,
    "INSTCTRL": 0x8E, "MDRP": 0xC0, "MIRP": 0xE0}


def _push_bytes(values: List[int]) -> bytes:
    if all(0 <= v <= 255 for v in values):
        if len(values) <= 8:
            return bytes([0xB0 + len(values) - 1] + values)
        return bytes([0x40, len(values)] + values)
    words = b"".join((v & 0xFFFF).to_bytes(2, "big") for v in values)
    if len(values) <= 8:
        return bytes([0xB8 + len(values) - 1]) + words
    return bytes([0x41, len(values)]) + words


def assemble(tokens: Sequence) -> bytes:
    """Bytecode of ``tokens``: ints are pushed (consecutive ones by one
    push instruction, at most 255), ``bytes`` are copied as they are
    (undefined opcodes), strings are instructions, ``"MDRP[11100]"``
    with its flag bits."""
    out = bytearray()
    pending: List[int] = []
    for tok in list(tokens) + [None]:
        if isinstance(tok, int) and not isinstance(tok, bool):
            pending.append(tok)
            if len(pending) == 255:
                out += _push_bytes(pending)
                pending = []
            continue
        if pending:
            out += _push_bytes(pending)
            pending = []
        if tok is None:
            break
        if isinstance(tok, bytes):
            out += tok
            continue
        name, _, bits = tok.partition("[")
        out.append(_OPCODES[name] + (int(bits[:-1], 2) if bits[:-1]
                                     else 0))
    return bytes(out)


def record(point: int, *expr) -> list:
    """Set point ``point``'s y to the value ``expr`` leaves (SCFS)."""
    return [point, *expr, "SVTCA[0]", "SCFS"]


def _program(tokens: Sequence) -> ttProgram.Program:
    p = ttProgram.Program()
    p.fromBytecode(assemble(tokens))
    return p


def _contour_glyph() -> Glyph:
    pen = TTGlyphPen(None)
    for contour in OUTLINE:
        pen.moveTo(contour[0])
        k = 1
        while k < len(contour):
            pt = contour[k]
            if pt[0] == "q":
                pen.qCurveTo(pt[1:], contour[k + 1])
                k += 2
            else:
                pen.lineTo(pt)
                k += 1
        pen.closePath()
    return pen.glyph()


def build_font(programs: Sequence[Sequence[str]], *,
               prep: Sequence = (0, "POP"),
               composites: Sequence[dict] = (), cvt=CVT,
               fpgm: Sequence = None, lsb_shift: int = 0) -> bytes:
    """A font whose glyph ``1 + i`` carries ``programs[i]``; then one
    composite glyph per entry of ``composites`` (``components``: a list of
    (glyph, flags, arg1, arg2, transform or None); ``program``: the
    composite's own instructions or None). ``lsb_shift`` moves every
    glyph's left side bearing off its ``xMin``."""
    fb = FontBuilder(UPEM, isTTF=True)
    names = [".notdef"] + [f"g{i}" for i in range(len(programs))] + \
        [f"c{i}" for i in range(len(composites))]
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(names[1:])})
    glyphs: Dict[str, Glyph] = {".notdef": _contour_glyph()}
    for i in range(len(programs)):
        glyphs[f"g{i}"] = _contour_glyph()
    for i, comp in enumerate(composites):
        g = Glyph()
        g.numberOfContours = -1
        g.components = []
        for glyph, flags, a1, a2, transform in comp["components"]:
            c = GlyphComponent()
            c.glyphName = names[glyph]
            c.flags = flags
            if flags & 0x2:
                c.x, c.y = a1, a2
            else:
                c.firstPt, c.secondPt = a1, a2
            if transform is not None:
                c.transform = [list(row) for row in transform]
            g.components.append(c)
        glyphs[f"c{i}"] = g
    fb.setupGlyf(glyphs)
    glyf = fb.font["glyf"]
    for i, asm in enumerate(programs):
        glyf[f"g{i}"].program = _program(asm)
    for i, comp in enumerate(composites):
        if comp.get("program"):
            glyf[f"c{i}"].program = _program(comp["program"])
    fb.setupHorizontalMetrics({n: (600 + 7 * k, getattr(glyf[n], "xMin", 0)
                                   - lsb_shift)
                               for k, n in enumerate(names)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Probe", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=760, sTypoDescender=-240, usWinAscent=800,
                usWinDescent=200)
    fb.setupPost()
    fb.font["head"].flags |= 8
    for tag, asm in (("fpgm", FPGM if fpgm is None else fpgm),
                     ("prep", prep)):
        if asm is not None:
            table = fb.font[tag] = newTable(tag)
            table.program = _program(asm)
    table = fb.font["cvt "] = newTable("cvt ")
    table.values = array.array("h", cvt)
    maxp = fb.font["maxp"]
    maxp.maxZones, maxp.maxTwilightPoints, maxp.maxStorage = 2, 8, 16
    maxp.maxFunctionDefs, maxp.maxInstructionDefs = 16, 4
    maxp.maxStackElements, maxp.maxSizeOfInstructions = 64, 2000
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()




def _flag_programs(op: str, args) -> List[list]:
    """``op`` with each of its 32 flag combinations."""
    return [["SVTCA[0]", *args, f"{op}[{flags:05b}]", "IUP[0]", "IUP[1]"]
            for flags in range(32)]


def _rounded(state, value):
    return [*state, value, "ROUND[00]"]


# the programs, by instruction family
PROGRAMS: Dict[str, list] = {
    "arithmetic": [
        *record(0, 160, 96, "MUL"), *record(1, 32, 1, "MUL"),
        *record(2, -32, 1, "MUL"), *record(3, 64, 192, "DIV"),
        *record(4, -64, 192, "DIV"), *record(5, -1, "FLOOR"),
        *record(6, -65, "CEILING"), *record(7, 1, "CEILING")],
    "logic": [
        *record(0, 3, 5, "LT", 7, 5, "GTEQ", "ADD", 64, "MUL"),
        *record(1, 5, 5, "LTEQ", 5, 6, "GT", 6, "MUL", "ADD", 6400, "MUL"),
        *record(2, 4, 4, "EQ", 4, 9, "NEQ", "AND", 0, 1, "OR", "ADD", 0,
                "NOT", "ADD", 64, "MUL"),
        *record(3, -100, "ABS", 30, "NEG", "ADD"),
        *record(4, 300, -7, "MAX", 20, 50, "MIN", "SUB"),
        *record(5, 96, "ODD", 100, "EVEN", "ADD", 64, "MUL")],
    "stack": [
        *record(0, 11, 22, 33, "ROLL", "SWAP", "POP", "ADD", "DUP", "ADD"),
        *record(1, 1, 2, 3, 4, "DEPTH", "CINDEX", 3, "MINDEX", "ADD",
                "SWAP", "POP", "SWAP", "POP", 16, "MUL"),
        9, 9, 9, "CLEAR", 2, "DEPTH", "SVTCA[0]", "SCFS",
        *record(3, 5, 6, 7, 0, "CINDEX", 64, "ADD", "SWAP", "POP",
                "SWAP", "POP", "SWAP", "POP")],
    "rounding": [
        *record(0, *_rounded(["RTG"], 95)),
        *record(1, *_rounded(["RTG"], -96)),
        *record(2, *_rounded(["RTHG"], 70)),
        *record(3, *_rounded(["RTDG"], 47)),
        *record(4, *_rounded(["RDTG"], -127)),
        *record(5, *_rounded(["RUTG"], 1)),
        *record(6, *_rounded(["ROFF"], 37)),
        *record(7, *_rounded(["RTHG"], -1))],
    "super_rounding": [
        *record(0, *_rounded([0x58, "SROUND"], 100)),
        *record(1, *_rounded([0x58, "SROUND"], 130)),
        *record(2, *_rounded([0x8F, "SROUND"], -150)),
        *record(3, *_rounded([0x01, "SROUND"], 41)),
        *record(4, *_rounded([0x40, "S45ROUND"], 100)),
        *record(5, *_rounded([0x40, "S45ROUND"], 67)),
        *record(6, *_rounded([0x5C, "S45ROUND"], -88)),
        *record(7, *_rounded([0xFA, "SROUND"], 200))],
    "nround_odd_even": [
        "RTHG", *record(0, 70, "NROUND[00]"),
        *record(1, 70, "ODD", 640, "MUL"),
        *record(2, 96, "EVEN", 640, "MUL"),
        "RTG", *record(3, 96, "EVEN", 640, "MUL"),
        *record(4, 0x62, "SROUND", 150, "ODD", 640, "MUL"),
        *record(5, "RDTG", -100, "ODD", 640, "MUL"),
        *record(6, "RUTG", 8, "EVEN", 640, "MUL"),
        *record(7, "RTHG", -128, "ODD", 640, "MUL")],
    "flow": [
        *record(0, 1, "IF", 100, "ELSE", 200, "EIF"),
        *record(1, 0, "IF", 100, "ELSE", 1, "IF", 300, "ELSE", 400,
                "EIF", "EIF"),
        *record(2, 77, 4, "JMPR", 66, 99),
        *record(3, 10, 5, 1, "JROT", 20, 30, "ADD"),
        *record(4, 10, 5, 0, "JROF", 20, 30, "ADD"),
        *record(5, 50, 2, "CALL"),
        7, 0, "WS", 3, 3, "LOOPCALL", *record(6, 7, "RS"),
        *record(7, 1, 0, "IF", 2, "ELSE", 3, "IF", 4, "EIF", "EIF",
                "ADD", 64, "MUL")],
    "backward_jump": [
        0, 3, "SWAP", 64, "ADD", "SWAP", 1, "SUB", "DUP", -13, "SWAP",
        "JROT", "POP", 2, "SWAP", "SVTCA[0]", "SCFS"],
    "cvt_storage": [
        3, 120, "WCVTP", *record(0, 3, "RCVT"),
        4, 10, "WCVTF", *record(1, 4, "RCVT"),
        5, 222, "WS", *record(2, 5, "RS"),
        *record(3, 99, "RS"), *record(4, 99, "RCVT"),
        *record(5, "MPPEM", 64, "MUL"), *record(6, "MPS"),
        *record(7, 8, "RCVT")],
    "delta_c": [
        0x13, 2, 0x5F, 2, 0xA6, 7, 3, "DELTAC1",
        17, "SDB", 2, "SDS", 0x07, 8, 1, "DELTAC2",
        0x37, 1, 1, "DELTAC3",
        *record(0, 2, "RCVT"), *record(1, 7, "RCVT"),
        *record(2, 8, "RCVT"), *record(3, 1, "RCVT")],
    "getinfo": [
        *(tok for i, sel in enumerate((1, 2, 4, 8, 32, 64, 1024, 6400))
          for tok in record(i, sel, "GETINFO"))],
    "vectors": [
        0, 2, "SPVTL[0]", *record(0, "GPV", "POP"),
        0, 2, "SPVTL[1]", *record(1, "GPV", "SWAP", "POP"),
        5, 3, "SFVTL[1]", *record(2, "GFV", "POP"),
        5, 3, "SFVTL[0]", *record(3, "GFV", "SWAP", "POP"),
        3, -7, "SPVFS", *record(4, "GPV", "POP"),
        100, 0, "SFVFS", "SFVTPV", *record(5, "GFV", "ADD"),
        1, 4, "SDPVTL[1]", *record(6, "GPV", "POP"),
        2, 2, "SPVTL[0]", *record(7, "GPV", "ADD")],
    "measure": [
        *record(0, 1, "GC[0]"), *record(1, 2, "GC[1]"),
        2, 4, 6, 4, 2, "SPVTL[0]", "MD[0]", "SVTCA[0]", "SCFS",
        *record(3, 6, 1, "MD[1]"), *record(4, 5, 1, "MD[0]"),
        0, 7, "SDPVTL[0]", 5, 2, "GC[1]", "SVTCA[0]", "SCFS",
        *record(6, 4, 1, "MD[1]")],
    "mdap_miap": [
        "SVTCA[0]", 1, "MDAP[1]", 5, "MDAP[0]", 2, 3, "MIAP[1]",
        4, 7, "MIAP[0]", 3, 2, "MIAP[1]", 20, "SCVTCI", 6, 8, "MIAP[1]",
        "IUP[0]", "IUP[1]"],
    "mirp_cutin": [
        "SVTCA[0]", 0, "MDAP[1]", 40, "SCVTCI", 1, 3, "MIRP[11101]",
        96, "SMD", 7, 4, "MIRP[01100]", 2, 5, "MIRP[10110]",
        "FLIPOFF", 6, 5, "MIRP[00111]", "FLIPON", 5, -1, "MIRP[11000]",
        "IUP[0]", "IUP[1]"],
    "single_width": [
        "SVTCA[0]", 0, "MDAP[1]", 300, "SSW", 64, "SSWCI",
        1, 2, "MIRP[10100]", 4, "MDRP[11100]", 6, 3, "MIRP[00101]",
        "IUP[0]", "IUP[1]"],
    "msirp_alignrp": [
        "SVTCA[0]", 0, "MDAP[1]", 2, 100, "MSIRP[1]", 4, -70, "MSIRP[0]",
        5, 6, 2, "SLOOP", "ALIGNRP", 7, 3, "ALIGNPTS", "IUP[0]", "IUP[1]"],
    "ip_shp": [
        "SVTCA[0]", 0, "MDAP[1]", 2, "MDRP[11100]", 0, "SRP1", 2, "SRP2",
        1, 3, 5, 3, "SLOOP", "IP", 6, 7, 2, "SLOOP", "SHP[1]",
        4, "SHP[0]", "IUP[0]", "IUP[1]"],
    "shc_shz_shpix": [
        "SVTCA[0]", 5, "MDAP[1]", 5, "SRP1", 0, "SHC[1]", 0, "MDAP[1]",
        0, "SRP2", 1, "SHZ[0]", 6, 7, 40, "SHPIX",
        3, 2, -20, 2, "SLOOP", "SHPIX", "IUP[0]", "IUP[1]"],
    "isect_utp": [
        1, 0, 1, 6, 7, "ISECT", 4, 2, 3, 5, 0, "ISECT",
        3, 0, 1, 3, 4, "ISECT", "SVTCA[0]", 6, "UTP", "IUP[0]", "IUP[1]"],
    "delta_p": [
        "SVTCA[0]", 0, "MDAP[1]", 1, "MDAP[1]",
        0x13, 0, 0x5F, 1, 0xC7, 0, 0xA3, 1, 4, "DELTAP1",
        20, "SDB", 1, "SDS", 0x0A, 0, 0x1F, 1, 2, "DELTAP2",
        0x24, 0, 1, "DELTAP3", 0x77, 3, 1, "DELTAP1", "IUP[0]", "IUP[1]"],
    "diagonal": [
        0, 2, "SFVTL[0]", 4, 3, "SPVTL[1]", 0, "MDAP[1]",
        1, "MDRP[11101]", 4, 2, "MIRP[10100]", 7, 5, 6, 2, "SLOOP",
        "ALIGNRP", "SVTCA[0]", "IUP[0]", "IUP[1]"],
    "flips": [
        1, 2, 2, "SLOOP", "FLIPPT", 5, 7, "FLIPRGOFF", 6, 6, "FLIPRGON",
        3, "FLIPPT"],
    "twilight": [
        0, "SZP0", "SVTCA[0]", 1, 3, "MIAP[1]", 2, 6, "MIAP[0]",
        1, "SRP0", 1, "SZP1", 2, 4, "MIRP[10101]",
        0, "SZP1", 3, 2, "MIRP[10100]", 4, 90, "MSIRP[0]",
        0, "SZP2", 4, 30, "SHPIX", 1, "SZPS",
        0, "SZP0", 3, "SRP0", 5, "MDRP[10000]",
        1, "SZP0", 0, "SZP2", 2, "SRP1", 3, "SRP2", 4, "IP",
        1, "SZPS", 0, "SZP0", 7, 3, 4, 1, 2, "ISECT",
        1, "SZP0", 0, "SZP1", 6, 4, "MD[1]", 0, "SZP2", "SVTCA[0]",
        1, "SWAP", 1, "SZP2", "SCFS", "IUP[0]", "IUP[1]"],
    "idef_and_undefined": [
        *record(0, 64, b"\x91"), *record(1, 123), b"\x28",
        *record(2, 456)],
    "scan_and_no_ops": [
        0x1FF, "SCANCTRL", 2, "SCANTYPE", 5, "SANGW", 3, "AA",
        *record(0, 321), 1, "DEBUG", *record(1, 654)],
    "errors_stop": [*record(0, 111), 64, 0, "DIV", *record(1, 222)],
    "out_of_range": [
        "SVTCA[0]", 99, "MDAP[1]", 1, 99, "MIRP[10100]", 99, 1,
        "MIAP[1]", *record(2, 77), 40, "CALL", *record(3, 88)],
    "iup_twice": [
        "SVTCA[0]", 0, "MDAP[1]", "IUP[0]", "IUP[1]", 1, 64, "SHPIX",
        2, 64, "MSIRP[0]", "IUP[0]", 3, 4, "FLIPRGOFF"],
    "instctrl_glyph": [
        4, 3, "INSTCTRL", "SVTCA[1]", 0, "MDAP[1]", 2, "MDRP[11100]",
        "IUP[1]", "IUP[0]"],
    "stack_underflow": [
        "ADD", "SVTCA[0]", 1, "SWAP", "SCFS", *record(2, 50)],
}
MDRP_FLAGS = _flag_programs("MDRP", (0, 1))
MIRP_FLAGS = _flag_programs("MIRP", (0, 3, 1))
# backward compatibility off for the whole font (INSTCTRL selector 3)
PREP_NO_COMPAT = [4, 3, "INSTCTRL"]
