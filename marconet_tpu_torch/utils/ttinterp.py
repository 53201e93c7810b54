"""FreeType's TrueType bytecode interpreter, version 40, in exact integers.

Pillow loads glyphs with ``FT_LOAD_DEFAULT``: FreeType's TrueType module
runs the font's ``fpgm`` once, its ``prep`` once a size and each glyph's
program on the glyph's scaled points (interpreter v40, "minimal"
subpixel hinting). This module is that interpreter, so that the port's
glyphs (``utils/truetype.py``, ``raster.py``) are Pillow's point for
point; ``tests/test_torch_hinting.py`` holds it to Pillow's own FreeType.

The whole instruction set of the OpenType specification is here, with
FreeType's undocumented rules (twilight-zone MIAP / MIRP / MSIRP, cvt[-1],
SHZ on zp2, ...) and its non-pedantic error handling: a reference out of
range is skipped, and any other error (an undefined opcode that no IDEF
defines, a bad jump, a division by zero, an overflow) stops the program
where it stands, keeping what it did. Arithmetic is FreeType's: 26.6
coordinates, F2Dot14 vectors (``FT_Vector_NormLen`` behind SPVTL, SFVTL,
SDPVTL, SPVFS, SFVFS), ``FT_MulDiv`` / ``FT_MulFix`` rounding, all on
Python ints.

Backward compatibility (v40) is on unless ``prep`` sets INSTCTRL
selector 3: glyph points do not move along x; once IUP[x] and IUP[y]
have both run no point moves and a third IUP returns at once; DELTAP and
SHPIX move only along y, only points already touched in y (or any point
of a composite when the freedom vector has a y part), and only before
both IUPs, except that SHPIX always moves twilight points; FLIPPT and
FLIPRGON / FLIPRGOFF stop after both IUPs. ISECT still moves x.

Per-size state: ``prep`` runs on the CVT scaled by the size and leaves the
graphics state (less its vectors, zone pointers, reference points and
loop), the CVT, the storage and the twilight zone that every glyph
program of the size starts from; a glyph program's writes to the CVT and
the storage do not reach the next glyph (FreeType copies them on write).
FreeType keeps a glyph program's moves of twilight points for the next
glyph program of the same size object; here every glyph program starts
from ``prep``'s twilight zone, so that a glyph does not depend on the
glyphs loaded before it and its bitmap can be cached. The two differ only
for a font whose glyph program reads a twilight point that an earlier
glyph program moved (DejaVu Sans's glyph programs do not use the twilight
zone).

Where FreeType's rules go beyond the specification, they were taken from
its behaviour on fonts built to show them (``tests/truetype_programs.py``):
ODD and EVEN look at the rounded value's whole pixels (bit 6), the
freedom and projection vectors' dot product is rounded like a
projection, GETINFO answers v40 with ClearType grayscale bits only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

TOUCH_X = 0x08
TOUCH_Y = 0x10
TOUCH_BOTH = TOUCH_X | TOUCH_Y
ON_CURVE = 0x01

FONT_RANGE, CVT_RANGE, GLYPH_RANGE = 1, 2, 3
MAX_RUNNABLE_OPCODES = 1000000
CALL_STACK_SIZE = 32

# round states
HALF_GRID, GRID, DOUBLE_GRID, DOWN_TO_GRID, UP_TO_GRID, OFF, SUPER, \
    SUPER_45 = range(8)

# (pops, pushes) of every opcode (FreeType's ``Pop_Push_Count``)
_POP_PUSH = [
    # 0x00: SVTCA y..SFVTCA x, SPVTL, SPVTL, SFVTL, SFVTL, SPVFS, SFVFS,
    # GPV, GFV, SFVTPV, ISECT
    (0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (2, 0), (2, 0),
    (2, 0), (2, 0), (2, 0), (2, 0), (0, 2), (0, 2), (0, 0), (5, 0),
    # 0x10: SRP0-2, SZP0-2, SZPS, SLOOP, RTG, RTHG, SMD, ELSE, JMPR,
    # SCVTCI, SSWCI, SSW
    (1, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0),
    (0, 0), (0, 0), (1, 0), (0, 0), (1, 0), (1, 0), (1, 0), (1, 0),
    # 0x20: DUP, POP, CLEAR, SWAP, DEPTH, CINDEX, MINDEX, ALIGNPTS, 0x28,
    # UTP, LOOPCALL, CALL, FDEF, ENDF, MDAP[0], MDAP[1]
    (1, 2), (1, 0), (0, 0), (2, 2), (0, 1), (1, 1), (1, 0), (2, 0),
    (0, 0), (1, 0), (2, 0), (1, 0), (1, 0), (0, 0), (1, 0), (1, 0),
    # 0x30: IUP y, IUP x, SHP, SHP, SHC, SHC, SHZ, SHZ, SHPIX, IP, MSIRP,
    # MSIRP, ALIGNRP, RTDG, MIAP, MIAP
    (0, 0), (0, 0), (0, 0), (0, 0), (1, 0), (1, 0), (1, 0), (1, 0),
    (1, 0), (0, 0), (2, 0), (2, 0), (0, 0), (0, 0), (2, 0), (2, 0),
    # 0x40: NPUSHB, NPUSHW, WS, RS, WCVTP, RCVT, GC, GC, SCFS, MD, MD,
    # MPPEM, MPS, FLIPON, FLIPOFF, DEBUG
    (0, 0), (0, 0), (2, 0), (1, 1), (2, 0), (1, 1), (1, 1), (1, 1),
    (2, 0), (2, 1), (2, 1), (0, 1), (0, 1), (0, 0), (0, 0), (1, 0),
    # 0x50: LT, LTEQ, GT, GTEQ, EQ, NEQ, ODD, EVEN, IF, EIF, AND, OR,
    # NOT, DELTAP1, SDB, SDS
    (2, 1), (2, 1), (2, 1), (2, 1), (2, 1), (2, 1), (1, 1), (1, 1),
    (1, 0), (0, 0), (2, 1), (2, 1), (1, 1), (1, 0), (1, 0), (1, 0),
    # 0x60: ADD, SUB, DIV, MUL, ABS, NEG, FLOOR, CEILING, ROUND x4,
    # NROUND x4
    (2, 1), (2, 1), (2, 1), (2, 1), (1, 1), (1, 1), (1, 1), (1, 1),
    (1, 1), (1, 1), (1, 1), (1, 1), (1, 1), (1, 1), (1, 1), (1, 1),
    # 0x70: WCVTF, DELTAP2, DELTAP3, DELTAC1-3, SROUND, S45ROUND, JROT,
    # JROF, ROFF, 0x7B, RUTG, RDTG, SANGW, AA
    (2, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0), (1, 0),
    (2, 0), (2, 0), (0, 0), (0, 0), (0, 0), (0, 0), (1, 0), (1, 0),
    # 0x80: FLIPPT, FLIPRGON, FLIPRGOFF, 0x83, 0x84, SCANCTRL, SDPVTL x2,
    # GETINFO, IDEF, ROLL, MAX, MIN, SCANTYPE, INSTCTRL, 0x8F
    (0, 0), (2, 0), (2, 0), (0, 0), (0, 0), (1, 0), (2, 0), (2, 0),
    (1, 1), (1, 0), (3, 3), (2, 1), (2, 1), (1, 0), (2, 0), (0, 0),
] + [(0, 0)] * 2 + [(0, 1)] + [(0, 0)] * 29 \
  + [(0, n) for n in range(1, 9)] * 2 + [(1, 0)] * 32 + [(2, 0)] * 32
assert len(_POP_PUSH) == 256
POPS = [p for p, _ in _POP_PUSH]
PUSHES = [q for _, q in _POP_PUSH]


class TTError(Exception):
    """An error that stops a program (FreeType's ``exc->error``)."""


# ---------------------------------------------------------------------------
# FreeType's integer arithmetic
# ---------------------------------------------------------------------------


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def mul_div(a: int, b: int, c: int) -> int:
    """``FT_MulDiv``: a * b / c rounded half away from zero; 0x7FFFFFFF
    for c = 0."""
    neg = (a < 0) ^ (b < 0) ^ (c < 0)
    a, b, c = abs(a), abs(b), abs(c)
    d = (a * b + (c >> 1)) // c if c else 0x7FFFFFFF
    return -d if neg else d


def mul_div_no_round(a: int, b: int, c: int) -> int:
    """``FT_MulDiv_No_Round``: a * b / c truncated toward zero."""
    neg = (a < 0) ^ (b < 0) ^ (c < 0)
    a, b, c = abs(a), abs(b), abs(c)
    d = a * b // c if c else 0x7FFFFFFF
    return -d if neg else d


def mul_fix(a: int, b: int) -> int:
    """``FT_MulFix``: a * b / 65536 rounded half away from zero."""
    c = (abs(a) * abs(b) + 0x8000) >> 16
    return c if (a < 0) == (b < 0) else -c


def div_fix(a: int, b: int) -> int:
    """``FT_DivFix``: a * 65536 / b rounded half away from zero."""
    neg = (a < 0) ^ (b < 0)
    a, b = abs(a), abs(b)
    q = ((a << 16) + (b >> 1)) // b if b else 0x7FFFFFFF
    return -q if neg else q


def mul_fix14(a: int, b: int) -> int:
    """``TT_MulFix14``: a * b / 16384 rounded half away from zero."""
    p = a * b
    return (p + 0x2000 - (p < 0)) >> 14


def dot_fix14(ax: int, ay: int, bx: int, by: int) -> int:
    """``TT_DotFix14``: (ax bx + ay by) / 16384 rounded half away from
    zero."""
    p = ax * bx + ay * by
    return (p + 0x2000 - (p < 0)) >> 14


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def vector_norm_len(x: int, y: int):
    """``FT_Vector_NormLen``'s unit vector (16.16) of (x, y), in its 32-bit
    arithmetic: a prenormalization and Newton's iterations."""
    x_, y_ = _i32(x), _i32(y)
    sx, sy = (-1 if x_ < 0 else 1), (-1 if y_ < 0 else 1)
    ux, uy = abs(x_) & 0xFFFFFFFF, abs(y_) & 0xFFFFFFFF
    if ux == 0:
        return (0, sy * 0x10000) if uy > 0 else (0, 0)
    if uy == 0:
        return (sx * 0x10000, 0)
    l = ux + (uy >> 1) if ux > uy else uy + (ux >> 1)
    shift = 31 - (l.bit_length() - 1)
    shift -= 15 + (l >= (0xAAAAAAAA >> shift))
    if shift > 0:
        ux = (ux << shift) & 0xFFFFFFFF
        uy = (uy << shift) & 0xFFFFFFFF
        l = ux + (uy >> 1) if ux > uy else uy + (ux >> 1)
    else:
        ux >>= -shift
        uy >>= -shift
        l >>= -shift
    b = _i32(0x10000 - l)
    xs, ys = _i32(ux), _i32(uy)
    while True:
        u = (xs + (_i32(xs * b) >> 16)) & 0xFFFFFFFF
        v = (ys + (_i32(ys * b) >> 16)) & 0xFFFFFFFF
        z = _tdiv(-_i32(u * u + v * v), 0x200)
        z = _tdiv(_i32(z * ((0x10000 + b) >> 8)), 0x10000)
        b += z
        if z <= 0:
            break
    return (-u if sx < 0 else u), (-v if sy < 0 else v)


_ARCTAN = (1740967, 919879, 466945, 234379, 117304, 58666, 29335, 14668,
           7334, 3667, 1833, 917, 458, 229, 115, 57, 29, 14, 7, 4, 2, 1)
_ANGLE_PI, _ANGLE_PI2 = 180 << 16, 90 << 16


def hypot(x: int, y: int) -> int:
    """``FT_Hypot``: the length of (x, y) by FreeType's CORDIC
    (``FT_Vector_Length``)."""
    if x == 0:
        return abs(y)
    if y == 0:
        return abs(x)
    msb = (abs(x) | abs(y)).bit_length() - 1
    if msb <= 29:                        # FT_TRIG_SAFE_MSB
        shift = 29 - msb
        x, y = x << shift, y << shift
    else:
        shift = msb - 29
        x, y = x >> shift, y >> shift
        shift = -shift
    # pseudo-polarize: into [-PI/4, PI/4], then 22 pseudo-rotations
    if y > x:
        if y > -x:
            x, y = y, -x
        else:
            x, y = -x, -y
    elif y < -x:
        x, y = -y, x
    b = 1
    for i in range(1, 23):
        if y > 0:
            x, y = x + ((y + b) >> i), y - ((x + b) >> i)
        else:
            x, y = x - ((y + b) >> i), y + ((x + b) >> i)
        b <<= 1
    # the CORDIC gain
    v = (abs(x) * 0xDBD95B16 + 0x40000000) >> 32
    v = -v if x < 0 else v
    if shift > 0:
        return (v + (1 << (shift - 1))) >> shift
    return (v << -shift) & 0xFFFFFFFF


def normalize(vx: int, vy: int):
    """FreeType's ``Normalize``: the F2Dot14 unit vector of (vx, vy), or
    None for (0, 0) (the vector is then left as it was)."""
    if vx == 0 and vy == 0:
        return None
    ux, uy = vector_norm_len(vx, vy)
    return _tdiv(ux, 4), _tdiv(uy, 4)


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


# ---------------------------------------------------------------------------
# zones and programs
# ---------------------------------------------------------------------------


class Zone:
    """A glyph zone (or the twilight zone): original (``org``), current
    (``cur``) and unscaled (``orus``) coordinates, touch and on-curve
    tags, and the contours' last point indices."""

    __slots__ = ("n_points", "ox", "oy", "cx", "cy", "ux", "uy", "tags",
                 "contours")

    def __init__(self, n_points: int = 0, contours=()):
        self.n_points = n_points
        self.ox = [0] * n_points
        self.oy = [0] * n_points
        self.cx = [0] * n_points
        self.cy = [0] * n_points
        self.ux = [0] * n_points
        self.uy = [0] * n_points
        self.tags = [0] * n_points
        self.contours = list(contours)

    @staticmethod
    def glyph(cx: List[int], cy: List[int], tags: List[int], contours,
              ux: Optional[List[int]] = None,
              uy: Optional[List[int]] = None) -> "Zone":
        """A glyph's zone over its current points (the outline's, then the
        four phantom points) and unscaled ones (a composite's are set when
        it is hinted)."""
        z = Zone()
        z.n_points = len(cx)
        z.cx, z.cy, z.tags, z.contours = cx, cy, tags, list(contours)
        if ux is not None:
            z.ux, z.uy = ux, uy
        return z

    def copy(self) -> "Zone":
        z = Zone.__new__(Zone)
        z.n_points = self.n_points
        z.ox, z.oy = self.ox[:], self.oy[:]
        z.cx, z.cy = self.cx[:], self.cy[:]
        z.ux, z.uy = self.ux[:], self.uy[:]
        z.tags = self.tags[:]
        z.contours = self.contours[:]
        return z


_EMPTY = Zone()


class Program:
    """A code range's bytes, decoded lazily at each offset reached:
    ``ins[ip] = (opcode, length, pushed values or None)``."""

    __slots__ = ("code", "size", "ins")

    def __init__(self, code: bytes):
        self.code = bytes(code)
        self.size = len(self.code)
        self.ins: Dict[int, tuple] = {}

    def at(self, ip: int):
        got = self.ins.get(ip)
        if got is None:
            got = self.ins[ip] = self._decode(ip)
        return got

    def _decode(self, ip: int):
        code, size = self.code, self.size
        op = code[ip]
        values = None
        if op == 0x40 or op == 0x41:                # NPUSHB, NPUSHW
            if ip + 1 >= size:
                raise TTError("Code_Overflow")
            n = code[ip + 1]
            length = 2 + n * (1 if op == 0x40 else 2)
            if ip + length > size:
                raise TTError("Code_Overflow")
            if op == 0x40:
                values = list(code[ip + 2:ip + length])
            else:
                values = [_s16((code[k] << 8) | code[k + 1])
                          for k in range(ip + 2, ip + length, 2)]
        elif 0xB0 <= op <= 0xB7:                    # PUSHB[n]
            length = 2 + (op - 0xB0)
            if ip + length > size:
                raise TTError("Code_Overflow")
            values = list(code[ip + 1:ip + length])
        elif 0xB8 <= op <= 0xBF:                    # PUSHW[n]
            length = 1 + 2 * (op - 0xB7)
            if ip + length > size:
                raise TTError("Code_Overflow")
            values = [_s16((code[k] << 8) | code[k + 1])
                      for k in range(ip + 1, ip + length, 2)]
        else:
            length = 1
        return op, length, values


class _Def:
    __slots__ = ("range", "opc", "start", "end", "active")

    def __init__(self):
        self.range = 0
        self.opc = -1
        self.start = 0
        self.end = 0
        self.active = False


class GraphicsState:
    """The graphics state (``TT_GraphicsState``)."""

    __slots__ = ("rp0", "rp1", "rp2", "dv_x", "dv_y", "pv_x", "pv_y",
                 "fv_x", "fv_y", "loop", "min_dist", "round_state",
                 "auto_flip", "cvt_cutin", "sw_cutin", "sw_value",
                 "delta_base", "delta_shift", "instruct_control",
                 "scan_control", "scan_type", "gep0", "gep1", "gep2")

    def __init__(self):                 # tt_default_graphics_state
        self.rp0 = self.rp1 = self.rp2 = 0
        self.dv_x = self.pv_x = self.fv_x = 0x4000
        self.dv_y = self.pv_y = self.fv_y = 0
        self.loop = 1
        self.min_dist = 64
        self.round_state = GRID
        self.auto_flip = True
        self.cvt_cutin = 68
        self.sw_cutin = 0
        self.sw_value = 0
        self.delta_base = 9
        self.delta_shift = 3
        self.instruct_control = 0
        self.scan_control = False
        self.scan_type = 0
        self.gep0 = self.gep1 = self.gep2 = 1

    def copy(self) -> "GraphicsState":
        g = GraphicsState.__new__(GraphicsState)
        for k in GraphicsState.__slots__:
            setattr(g, k, getattr(self, k))
        return g


# ---------------------------------------------------------------------------
# the execution context
# ---------------------------------------------------------------------------


class Interpreter:
    """One execution context: the font's limits, its function and
    instruction definitions, and the state of the program that runs."""

    def __init__(self, *, stack_size: int, max_fdefs: int, max_idefs: int,
                 fpgm: bytes, prep: bytes):
        self.stack_size = stack_size
        self.stack = [0] * (stack_size + 1)
        self.max_fdefs = max_fdefs
        self.max_idefs = max_idefs
        self.fdefs: Dict[int, _Def] = {}
        self.num_fdefs = 0
        self.max_func = 0
        self.idefs: List[_Def] = []
        self.ranges: Dict[int, Optional[Program]] = {
            FONT_RANGE: Program(fpgm) if fpgm else None,
            CVT_RANGE: Program(prep) if prep else None,
            GLYPH_RANGE: None}
        self.gs = GraphicsState()
        self.cvt: List[int] = []
        self.storage: List[int] = []
        self.twilight = Zone(0)
        self.pts = _EMPTY
        self.zp0 = self.zp1 = self.zp2 = _EMPTY
        self.period, self.phase, self.threshold = 64, 0, 0
        self.ppem = 0
        self.point_size = 0
        self.scale = 0                  # tt_metrics.scale
        self.x_scale = self.y_scale = 0  # metrics.x_scale, y_scale
        self.backward_compatibility = False
        self.is_composite = False
        self.iupx_called = self.iupy_called = False
        self.grayscale = False          # v40 answers ClearType grayscale
        self.subpixel_hinting_lean = True
        self.grayscale_cleartype = True

    # -- graphics-state derived values ---------------------------------------

    def compute_funcs(self) -> None:
        gs = self.gs
        if gs.fv_x == 0x4000:
            f_dot_p = gs.pv_x
        elif gs.fv_y == 0x4000:
            f_dot_p = gs.pv_y
        else:
            f_dot_p = dot_fix14(gs.pv_x, gs.pv_y, gs.fv_x, gs.fv_y)
        # 1: x, 2: y, 0: any
        self.proj = 1 if gs.pv_x == 0x4000 else 2 if gs.pv_y == 0x4000 else 0
        self.dual = 1 if gs.dv_x == 0x4000 else 2 if gs.dv_y == 0x4000 else 0
        self.move_mode = 0
        if f_dot_p == 0x4000:
            if gs.fv_x == 0x4000:
                self.move_mode = 1
            elif gs.fv_y == 0x4000:
                self.move_mode = 2
        if abs(f_dot_p) < 0x400:
            f_dot_p = 0x4000
        self.f_dot_p = f_dot_p

    def project(self, dx: int, dy: int) -> int:
        p = self.proj
        if p == 1:
            return dx
        if p == 2:
            return dy
        return dot_fix14(dx, dy, self.gs.pv_x, self.gs.pv_y)

    def dual_project(self, dx: int, dy: int) -> int:
        p = self.dual
        if p == 1:
            return dx
        if p == 2:
            return dy
        return dot_fix14(dx, dy, self.gs.dv_x, self.gs.dv_y)

    def round(self, d: int) -> int:
        """``func_round`` of the round state (engine compensation 0)."""
        s = self.gs.round_state
        if s == GRID:
            if d >= 0:
                v = (d + 32) & -64
                return v if v >= 0 else 0
            v = -((32 - d) & -64)
            return v if v <= 0 else 0
        if s == OFF:
            return d
        if s == HALF_GRID:
            if d >= 0:
                v = (d & -64) + 32
                return v if v >= 0 else 32
            v = -(((-d) & -64) + 32)
            return v if v <= 0 else -32
        if s == DOUBLE_GRID:
            if d >= 0:
                v = (d + 16) & -32
                return v if v >= 0 else 0
            v = -((16 - d) & -32)
            return v if v <= 0 else 0
        if s == DOWN_TO_GRID:
            if d >= 0:
                v = d & -64
                return v if v >= 0 else 0
            v = -((-d) & -64)
            return v if v <= 0 else 0
        if s == UP_TO_GRID:
            if d >= 0:
                v = (d + 63) & -64
                return v if v >= 0 else 0
            v = -((63 - d) & -64)
            return v if v <= 0 else 0
        period, phase, threshold = self.period, self.phase, self.threshold
        if s == SUPER:
            if d >= 0:
                v = ((d + threshold - phase) & -period) + phase
                return v if v >= 0 else phase
            v = -((threshold - phase - d) & -period) - phase
            return v if v <= 0 else -phase
        # SUPER_45
        if d >= 0:
            v = _tdiv(d + threshold - phase, period) * period + phase
            return v if v >= 0 else phase
        v = -(_tdiv(threshold - phase - d, period) * period) - phase
        return v if v <= 0 else -phase

    def set_super_round(self, grid_period: int, selector: int) -> None:
        sel = selector & 0xC0
        if sel == 0:
            period = grid_period // 2
        elif sel == 0x80:
            period = grid_period * 2
        else:
            period = grid_period
        sel = selector & 0x30
        phase = (0 if sel == 0 else period >> 2 if sel == 0x10
                 else period >> 1 if sel == 0x20 else period * 3 // 4)
        if selector & 0x0F == 0:
            threshold = period - 1
        else:
            threshold = _tdiv(((selector & 0x0F) - 4) * period, 8)
        self.period, self.phase, self.threshold = (period >> 8, phase >> 8,
                                                   threshold >> 8)

    # -- moves ---------------------------------------------------------------

    def _frozen_y(self) -> bool:
        return (self.backward_compatibility and self.iupx_called
                and self.iupy_called)

    def move(self, z: Zone, p: int, d: int) -> None:
        """``func_move``: ``Direct_Move`` and its x / y fast paths."""
        mode = self.move_mode
        if mode == 1:
            if not self.backward_compatibility:
                z.cx[p] += d
            z.tags[p] |= TOUCH_X
            return
        if mode == 2:
            if not self._frozen_y():
                z.cy[p] += d
            z.tags[p] |= TOUCH_Y
            return
        gs = self.gs
        if gs.fv_x != 0:
            if not self.backward_compatibility:
                z.cx[p] += mul_div(d, gs.fv_x, self.f_dot_p)
            z.tags[p] |= TOUCH_X
        if gs.fv_y != 0:
            if not self._frozen_y():
                z.cy[p] += mul_div(d, gs.fv_y, self.f_dot_p)
            z.tags[p] |= TOUCH_Y

    def move_orig(self, z: Zone, p: int, d: int) -> None:
        """``func_move_orig``."""
        mode = self.move_mode
        if mode == 1:
            z.ox[p] += d
            return
        if mode == 2:
            z.oy[p] += d
            return
        gs = self.gs
        if gs.fv_x != 0:
            z.ox[p] += mul_div(d, gs.fv_x, self.f_dot_p)
        if gs.fv_y != 0:
            z.oy[p] += mul_div(d, gs.fv_y, self.f_dot_p)

    def move_zp2(self, p: int, dx: int, dy: int, touch: bool) -> None:
        """``Move_Zp2_Point``."""
        z, gs = self.zp2, self.gs
        if gs.fv_x != 0:
            if not self.backward_compatibility:
                z.cx[p] += dx
            if touch:
                z.tags[p] |= TOUCH_X
        if gs.fv_y != 0:
            if not self._frozen_y():
                z.cy[p] += dy
            if touch:
                z.tags[p] |= TOUCH_Y

    # -- CVT and storage -----------------------------------------------------

    def _own_cvt(self) -> None:
        if self.ini_range == GLYPH_RANGE and self.cvt is self.orig_cvt:
            self.cvt = self.cvt[:]

    def _own_storage(self) -> None:
        if self.ini_range == GLYPH_RANGE and self.storage is self.orig_storage:
            self.storage = self.storage[:]

    # -- running -------------------------------------------------------------

    def goto_range(self, rng: int, ip: int) -> None:
        if rng < 1 or rng > 3:
            raise TTError("Bad_Argument")
        prog = self.ranges.get(rng)
        if prog is None:
            raise TTError("Invalid_CodeRange")
        if ip > prog.size:
            raise TTError("Code_Overflow")
        self.prog = prog
        self.ip = ip
        self.cur_range = rng

    def run(self, rng: int) -> Optional[str]:
        """Run code range ``rng`` from its start (``TT_RunIns``); the name
        of the error that stopped it, or None."""
        self.call_stack: List[list] = []
        self.top = 0
        self.iupx_called = self.iupy_called = False
        # FreeType's heuristic limits on LOOPCALL counts and backward jumps
        n_pts = self.pts.n_points
        cvt_size = len(self.cvt)
        if n_pts:
            self.loopcall_max = max(50, 10 * n_pts) + max(50, cvt_size // 10)
        else:
            self.loopcall_max = 300 + 22 * cvt_size
        self.loopcall_counter = 0
        self.neg_jump_max = self.loopcall_max
        self.neg_jump_counter = 0
        self.orig_cvt, self.orig_storage = self.cvt, self.storage
        self.ini_range = rng
        try:
            self.goto_range(rng, 0)
            self.compute_funcs()
            self._execute()
            error = None
        except TTError as e:
            error = str(e)
        if rng == GLYPH_RANGE:          # glyph programs work on copies
            self.cvt, self.storage = self.orig_cvt, self.orig_storage
        return error

    def _execute(self) -> None:
        stack = self.stack
        handlers = _HANDLERS
        count = 0
        while True:
            prog = self.prog
            if self.ip >= prog.size:
                if self.call_stack:
                    raise TTError("Code_Overflow")
                return
            op, length, values = prog.at(self.ip)
            pops = POPS[op]
            args = self.top - pops
            if args < 0:
                for i in range(pops):
                    stack[i] = 0
                args = 0
            self.args = args
            new_top = args + PUSHES[op]
            if new_top > self.stack_size:
                raise TTError("Stack_Overflow")
            self.new_top = new_top
            self.step_ins = True
            self.opcode = op
            self.length = length
            self.values = values
            handlers[op](self, args)
            self.top = self.new_top
            if self.step_ins:
                self.ip += length
            count += 1
            if count > MAX_RUNNABLE_OPCODES:
                raise TTError("Execution_Too_Long")

    def skip_code(self) -> None:
        """``SkipCode``: step to the next instruction (Code_Overflow past
        the end)."""
        self.ip += self.length
        if self.ip >= self.prog.size:
            raise TTError("Code_Overflow")
        self.opcode, self.length, _ = self.prog.at(self.ip)


# ---------------------------------------------------------------------------
# instructions
# ---------------------------------------------------------------------------


def _bad(n: int, limit: int) -> bool:
    """FreeType's ``BOUNDS`` / ``BOUNDSL``: an unsigned comparison."""
    return n < 0 or n >= limit


def i_svtca(e: Interpreter, a: int) -> None:
    op = e.opcode
    aa = (op & 1) << 14
    bb = aa ^ 0x4000
    gs = e.gs
    if op < 4:
        gs.pv_x, gs.pv_y = aa, bb
        gs.dv_x, gs.dv_y = aa, bb
    if op & 2 == 0:
        gs.fv_x, gs.fv_y = aa, bb
    e.compute_funcs()


def _line_vector(e: Interpreter, p_top: int, p_low: int, za: Zone,
                 zb: Zone, org: bool, opcode: int):
    """The vector from point ``p_top`` of ``zb`` to ``p_low`` of ``za``
    (original or current), turned a quarter counter-clockwise for odd
    ``opcode``; (0x4000, 0) for coincident points."""
    if org:
        a = za.ox[p_low] - zb.ox[p_top]
        b = za.oy[p_low] - zb.oy[p_top]
    else:
        a = za.cx[p_low] - zb.cx[p_top]
        b = za.cy[p_low] - zb.cy[p_top]
    if a == 0 and b == 0:
        a, opcode = 0x4000, 0
    if opcode & 1:
        a, b = -b, a
    return a, b


def _sxvtl(e: Interpreter, args: int):
    st = e.stack
    p1, p2 = st[args + 1] & 0xFFFF, st[args] & 0xFFFF
    if p1 >= e.zp2.n_points or p2 >= e.zp1.n_points:
        return None
    a, b = _line_vector(e, p1, p2, e.zp1, e.zp2, False, e.opcode)
    return normalize(a, b)


def i_spvtl(e: Interpreter, args: int) -> None:
    v = _sxvtl(e, args)
    if v is not None:
        gs = e.gs
        gs.pv_x, gs.pv_y = gs.dv_x, gs.dv_y = v
        e.compute_funcs()


def i_sfvtl(e: Interpreter, args: int) -> None:
    v = _sxvtl(e, args)
    if v is not None:
        e.gs.fv_x, e.gs.fv_y = v
        e.compute_funcs()


def i_spvfs(e: Interpreter, args: int) -> None:
    st = e.stack
    v = normalize(_s16(st[args]), _s16(st[args + 1]))
    gs = e.gs
    if v is not None:
        gs.pv_x, gs.pv_y = v
    gs.dv_x, gs.dv_y = gs.pv_x, gs.pv_y
    e.compute_funcs()


def i_sfvfs(e: Interpreter, args: int) -> None:
    st = e.stack
    v = normalize(_s16(st[args]), _s16(st[args + 1]))
    if v is not None:
        e.gs.fv_x, e.gs.fv_y = v
    e.compute_funcs()


def i_gpv(e: Interpreter, args: int) -> None:
    e.stack[args], e.stack[args + 1] = e.gs.pv_x, e.gs.pv_y


def i_gfv(e: Interpreter, args: int) -> None:
    e.stack[args], e.stack[args + 1] = e.gs.fv_x, e.gs.fv_y


def i_sfvtpv(e: Interpreter, args: int) -> None:
    e.gs.fv_x, e.gs.fv_y = e.gs.pv_x, e.gs.pv_y
    e.compute_funcs()


def i_isect(e: Interpreter, args: int) -> None:
    st = e.stack
    point = st[args] & 0xFFFF
    a0, a1 = st[args + 1] & 0xFFFF, st[args + 2] & 0xFFFF
    b0, b1 = st[args + 3] & 0xFFFF, st[args + 4] & 0xFFFF
    z0, z1, z2 = e.zp0, e.zp1, e.zp2
    if (b0 >= z0.n_points or b1 >= z0.n_points or a0 >= z1.n_points
            or a1 >= z1.n_points or point >= z2.n_points):
        return
    dbx = z0.cx[b1] - z0.cx[b0]
    dby = z0.cy[b1] - z0.cy[b0]
    dax = z1.cx[a1] - z1.cx[a0]
    day = z1.cy[a1] - z1.cy[a0]
    dx = z0.cx[b0] - z1.cx[a0]
    dy = z0.cy[b0] - z1.cy[a0]
    discriminant = mul_div(dax, -dby, 0x40) + mul_div(day, dbx, 0x40)
    dotproduct = mul_div(dax, dbx, 0x40) + mul_div(day, dby, 0x40)
    if 19 * abs(discriminant) > abs(dotproduct):
        val = mul_div(dx, -dby, 0x40) + mul_div(dy, dbx, 0x40)
        z2.cx[point] = z1.cx[a0] + mul_div(val, dax, discriminant)
        z2.cy[point] = z1.cy[a0] + mul_div(val, day, discriminant)
    else:
        z2.cx[point] = _tdiv(z1.cx[a0] + z1.cx[a1] + z0.cx[b0] + z0.cx[b1],
                             4)
        z2.cy[point] = _tdiv(z1.cy[a0] + z1.cy[a1] + z0.cy[b0] + z0.cy[b1],
                             4)
    z2.tags[point] |= TOUCH_BOTH


def i_srp0(e, a):
    e.gs.rp0 = e.stack[a] & 0xFFFF


def i_srp1(e, a):
    e.gs.rp1 = e.stack[a] & 0xFFFF


def i_srp2(e, a):
    e.gs.rp2 = e.stack[a] & 0xFFFF


def _zone(e: Interpreter, n: int) -> Optional[Zone]:
    if n == 0:
        return e.twilight
    if n == 1:
        return e.pts
    return None


def i_szp0(e, a):
    z = _zone(e, e.stack[a])
    if z is not None:
        e.zp0 = z
        e.gs.gep0 = e.stack[a]


def i_szp1(e, a):
    z = _zone(e, e.stack[a])
    if z is not None:
        e.zp1 = z
        e.gs.gep1 = e.stack[a]


def i_szp2(e, a):
    z = _zone(e, e.stack[a])
    if z is not None:
        e.zp2 = z
        e.gs.gep2 = e.stack[a]


def i_szps(e, a):
    z = _zone(e, e.stack[a])
    if z is not None:
        e.zp0 = e.zp1 = e.zp2 = z
        e.gs.gep0 = e.gs.gep1 = e.gs.gep2 = e.stack[a]


def i_sloop(e, a):
    v = e.stack[a]
    if v < 0:
        raise TTError("Bad_Argument")
    e.gs.loop = min(v, 0xFFFF)


def _set_round(state):
    def handler(e, a):
        e.gs.round_state = state
    return handler


def i_smd(e, a):
    e.gs.min_dist = e.stack[a]


def i_else(e, a):
    n_ifs = 1
    while n_ifs:
        e.skip_code()
        if e.opcode == 0x58:
            n_ifs += 1
        elif e.opcode == 0x59:
            n_ifs -= 1


def i_jmpr(e, a):
    off = e.stack[a]
    if off == 0 and e.args == 0:
        raise TTError("Bad_Argument")
    e.ip += off
    if e.ip < 0 or (e.call_stack and e.ip > e.call_stack[-1][3].end):
        raise TTError("Bad_Argument")
    e.step_ins = False
    if off < 0:
        e.neg_jump_counter += 1
        if e.neg_jump_counter > e.neg_jump_max:
            raise TTError("Execution_Too_Long")


def i_scvtci(e, a):
    e.gs.cvt_cutin = e.stack[a]


def i_sswci(e, a):
    e.gs.sw_cutin = e.stack[a]


def i_ssw(e, a):
    e.gs.sw_value = mul_fix(e.stack[a], e.scale)


def i_dup(e, a):
    e.stack[a + 1] = e.stack[a]


def i_pop(e, a):
    pass


def i_clear(e, a):
    e.new_top = 0


def i_swap(e, a):
    st = e.stack
    st[a], st[a + 1] = st[a + 1], st[a]


def i_depth(e, a):
    e.stack[a] = e.top


def i_cindex(e, a):
    st = e.stack
    n = st[a]
    st[a] = 0 if n <= 0 or n > e.args else st[e.args - n]


def i_mindex(e, a):
    st = e.stack
    n = st[a]
    if n <= 0 or n > e.args:
        return
    at = e.args - n
    k = st[at]
    st[at:e.args - 1] = st[at + 1:e.args]
    st[e.args - 1] = k


def i_alignpts(e, a):
    st = e.stack
    p1, p2 = st[a] & 0xFFFF, st[a + 1] & 0xFFFF
    z0, z1 = e.zp0, e.zp1
    if p1 >= z1.n_points or p2 >= z0.n_points:
        return
    d = _tdiv(e.project(z0.cx[p2] - z1.cx[p1], z0.cy[p2] - z1.cy[p1]), 2)
    e.move(z1, p1, d)
    e.move(z0, p2, -d)


def i_utp(e, a):
    p = e.stack[a] & 0xFFFF
    z = e.zp0
    if p >= z.n_points:
        return
    mask = 0xFF
    if e.gs.fv_x != 0:
        mask &= ~TOUCH_X
    if e.gs.fv_y != 0:
        mask &= ~TOUCH_Y
    z.tags[p] &= mask


def _function(e: Interpreter, f: int) -> _Def:
    if _bad(f, e.max_func + 1):
        raise TTError("Invalid_Reference")
    d = e.fdefs.get(f)
    if d is None or not d.active:
        raise TTError("Invalid_Reference")
    return d


def _call(e: Interpreter, d: _Def, count: int) -> None:
    e.call_stack.append([e.cur_range, e.ip + e.length, count, d])
    e.goto_range(d.range, d.start)
    e.step_ins = False


def i_loopcall(e, a):
    st = e.stack
    d = _function(e, st[a + 1])
    if len(e.call_stack) >= CALL_STACK_SIZE:
        raise TTError("Stack_Overflow")
    n = st[a]
    if n > 0:
        _call(e, d, n)
        e.loopcall_counter += n
        if e.loopcall_counter > e.loopcall_max:
            raise TTError("Execution_Too_Long")


def i_call(e, a):
    d = _function(e, e.stack[a])
    if len(e.call_stack) >= CALL_STACK_SIZE:
        raise TTError("Stack_Overflow")
    _call(e, d, 1)


def _skip_definition(e: Interpreter, d: _Def) -> None:
    while True:
        e.skip_code()
        if e.opcode in (0x89, 0x2C):
            raise TTError("Nested_DEFS")
        if e.opcode == 0x2D:
            d.end = e.ip
            return


def i_fdef(e, a):
    if e.ini_range == GLYPH_RANGE:
        raise TTError("DEF_In_Glyf_Bytecode")
    n = e.stack[a]
    d = e.fdefs.get(n) if n >= 0 else None
    if d is None:
        if e.num_fdefs >= e.max_fdefs:
            raise TTError("Too_Many_Function_Defs")
        e.num_fdefs += 1
        if n < 0 or n > 0xFFFF:
            raise TTError("Too_Many_Function_Defs")
        d = e.fdefs[n] = _Def()
    d.range, d.opc, d.start, d.active = e.cur_range, n, e.ip + 1, True
    e.max_func = max(e.max_func, n)
    _skip_definition(e, d)


def i_endf(e, a):
    if not e.call_stack:
        raise TTError("ENDF_In_Exec_Stream")
    rec = e.call_stack.pop()
    rec[2] -= 1
    e.step_ins = False
    if rec[2] > 0:
        e.call_stack.append(rec)
        e.ip = rec[3].start
    else:
        # the return address may lie just past the end of its range
        rng, ip = rec[0], rec[1]
        prog = e.ranges.get(rng)
        if prog is None:
            raise TTError("Invalid_CodeRange")
        if ip > prog.size:
            raise TTError("Code_Overflow")
        e.prog, e.ip, e.cur_range = prog, ip, rng


def i_mdap(e, a):
    p = e.stack[a] & 0xFFFF
    z = e.zp0
    if p >= z.n_points:
        return
    if e.opcode & 1:
        cur = e.project(z.cx[p], z.cy[p])
        d = e.round(cur) - cur
    else:
        d = 0
    e.move(z, p, d)
    e.gs.rp0 = e.gs.rp1 = p


def _iup_interpolate(org, cur, orus, p1: int, p2: int, ref1: int,
                     ref2: int, n: int) -> None:
    if p1 > p2 or ref1 >= n or ref2 >= n:
        return
    orus1, orus2 = orus[ref1], orus[ref2]
    if orus1 > orus2:
        orus1, orus2 = orus2, orus1
        ref1, ref2 = ref2, ref1
    org1, org2 = org[ref1], org[ref2]
    cur1, cur2 = cur[ref1], cur[ref2]
    delta1, delta2 = cur1 - org1, cur2 - org2
    if cur1 == cur2 or orus1 == orus2:
        for i in range(p1, p2 + 1):
            x = org[i]
            if x <= org1:
                x += delta1
            elif x >= org2:
                x += delta2
            else:
                x = cur1
            cur[i] = x
        return
    scale = None
    for i in range(p1, p2 + 1):
        x = org[i]
        if x <= org1:
            x += delta1
        elif x >= org2:
            x += delta2
        else:
            if scale is None:
                scale = div_fix(cur2 - cur1, orus2 - orus1)
            x = cur1 + mul_fix(orus[i] - orus1, scale)
        cur[i] = x


def i_iup(e, a):
    if e.backward_compatibility:
        if e.iupx_called and e.iupy_called:
            return
        if e.opcode & 1:
            e.iupx_called = True
        else:
            e.iupy_called = True
    z = e.pts
    if not z.contours:
        return
    if e.opcode & 1:
        mask, org, cur, orus = TOUCH_X, z.ox, z.cx, z.ux
    else:
        mask, org, cur, orus = TOUCH_Y, z.oy, z.cy, z.uy
    tags, n = z.tags, z.n_points
    point = 0
    first_point_index = 0
    for end in z.contours:
        end_point = end - first_point_index
        first_point = point
        if end_point >= n or end_point < 0:
            end_point = n - 1
        while point <= end_point and not tags[point] & mask:
            point += 1
        if point <= end_point:
            first_touched = cur_touched = point
            point += 1
            while point <= end_point:
                if tags[point] & mask:
                    _iup_interpolate(org, cur, orus, cur_touched + 1,
                                     point - 1, cur_touched, point, n)
                    cur_touched = point
                point += 1
            if cur_touched == first_touched:
                dx = cur[cur_touched] - org[cur_touched]
                if dx:
                    for i in range(first_point, end_point + 1):
                        if i != cur_touched:
                            cur[i] += dx
            else:
                _iup_interpolate(org, cur, orus, cur_touched + 1,
                                 end_point, cur_touched, first_touched, n)
                if first_touched > 0:
                    _iup_interpolate(org, cur, orus, first_point,
                                     first_touched - 1, cur_touched,
                                     first_touched, n)


def _displacement(e: Interpreter):
    """``Compute_Point_Displacement``: (dx, dy, zone, reference point) or
    None."""
    gs = e.gs
    if e.opcode & 1:
        z, p = e.zp0, gs.rp1
    else:
        z, p = e.zp1, gs.rp2
    if p >= z.n_points:
        return None
    d = e.project(z.cx[p] - z.ox[p], z.cy[p] - z.oy[p])
    return (mul_div(d, gs.fv_x, e.f_dot_p), mul_div(d, gs.fv_y, e.f_dot_p),
            z, p)


def i_shp(e, a):
    gs = e.gs
    if e.top < gs.loop:
        gs.loop = 1
        e.new_top = e.args
        return
    disp = _displacement(e)
    if disp is None:
        return
    dx, dy, _, _ = disp
    st = e.stack
    while gs.loop > 0:
        e.args -= 1
        p = st[e.args] & 0xFFFF
        if p < e.zp2.n_points:
            if e.backward_compatibility:
                e.move_zp2(p, 0, dy, True)
            else:
                e.move_zp2(p, dx, dy, True)
        gs.loop -= 1
    gs.loop = 1
    e.new_top = e.args


def i_shc(e, a):
    contour = _s16(e.stack[a])
    z2 = e.zp2
    bounds = 1 if e.gs.gep2 == 0 else len(z2.contours)
    if _bad(contour, bounds):
        return
    disp = _displacement(e)
    if disp is None:
        return
    dx, dy, zp, refp = disp
    start = 0 if contour == 0 else z2.contours[contour - 1] + 1
    limit = z2.n_points if e.gs.gep2 == 0 else z2.contours[contour] + 1
    for i in range(start, limit):
        if zp is not z2 or refp != i:
            e.move_zp2(i, dx, dy, True)


def i_shz(e, a):
    if _bad(e.stack[a], 2):
        return
    disp = _displacement(e)
    if disp is None:
        return
    dx, dy, zp, refp = disp
    z2 = e.zp2
    if e.gs.gep2 == 0:
        limit = z2.n_points
    elif e.gs.gep2 == 1 and z2.contours:
        limit = z2.contours[-1] + 1
    else:
        limit = 0
    for i in range(limit):
        if zp is not z2 or refp != i:
            e.move_zp2(i, dx, dy, False)


def i_shpix(e, a):
    gs = e.gs
    if e.top < gs.loop + 1:
        gs.loop = 1
        e.new_top = e.args
        return
    in_twilight = gs.gep0 == 0 or gs.gep1 == 0 or gs.gep2 == 0
    st = e.stack
    amount = st[a]
    dx = mul_fix14(amount, gs.fv_x)
    dy = mul_fix14(amount, gs.fv_y)
    z2 = e.zp2
    while gs.loop > 0:
        e.args -= 1
        p = st[e.args] & 0xFFFF
        if p < z2.n_points:
            if e.backward_compatibility:
                if in_twilight or (
                        not (e.iupx_called and e.iupy_called) and (
                            (e.is_composite and gs.fv_y != 0)
                            or z2.tags[p] & TOUCH_Y)):
                    e.move_zp2(p, 0, dy, True)
            else:
                e.move_zp2(p, dx, dy, True)
        gs.loop -= 1
    gs.loop = 1
    e.new_top = e.args


def i_ip(e, a):
    gs = e.gs
    if e.top < gs.loop:
        gs.loop = 1
        e.new_top = e.args
        return
    twilight = gs.gep0 == 0 or gs.gep1 == 0 or gs.gep2 == 0
    z0, z1, z2 = e.zp0, e.zp1, e.zp2
    rp1, rp2 = gs.rp1, gs.rp2
    if rp1 >= z0.n_points:
        gs.loop = 1
        e.new_top = e.args
        return
    if twilight:
        bx, by = z0.ox[rp1], z0.oy[rp1]
    else:
        bx, by = z0.ux[rp1], z0.uy[rp1]
    cbx, cby = z0.cx[rp1], z0.cy[rp1]
    same_scale = e.x_scale == e.y_scale

    def org_distance(z, p):
        if twilight:
            return e.dual_project(z.ox[p] - bx, z.oy[p] - by)
        if same_scale:
            return e.dual_project(z.ux[p] - bx, z.uy[p] - by)
        return e.dual_project(mul_fix(z.ux[p] - bx, e.x_scale),
                              mul_fix(z.uy[p] - by, e.y_scale))

    if rp2 >= z1.n_points:
        old_range = cur_range = 0
    else:
        old_range = org_distance(z1, rp2)
        cur_range = e.project(z1.cx[rp2] - cbx, z1.cy[rp2] - cby)
    st = e.stack
    while gs.loop > 0:
        e.args -= 1
        p = st[e.args]
        gs.loop -= 1
        if _bad(p, z2.n_points):
            continue
        org_dist = org_distance(z2, p)
        cur_dist = e.project(z2.cx[p] - cbx, z2.cy[p] - cby)
        if org_dist:
            new_dist = (mul_div(org_dist, cur_range, old_range)
                        if old_range else org_dist)
        else:
            new_dist = 0
        e.move(z2, p, new_dist - cur_dist)
    gs.loop = 1
    e.new_top = e.args


def i_msirp(e, a):
    st = e.stack
    p = st[a] & 0xFFFF
    gs = e.gs
    z0, z1 = e.zp0, e.zp1
    if p >= z1.n_points or gs.rp0 >= z0.n_points:
        return
    if gs.gep1 == 0:
        z1.ox[p], z1.oy[p] = z0.ox[gs.rp0], z0.oy[gs.rp0]
        e.move_orig(z1, p, st[a + 1])
        z1.cx[p], z1.cy[p] = z1.ox[p], z1.oy[p]
    d = e.project(z1.cx[p] - z0.cx[gs.rp0], z1.cy[p] - z0.cy[gs.rp0])
    e.move(z1, p, st[a + 1] - d)
    gs.rp1 = gs.rp0
    gs.rp2 = p
    if e.opcode & 1:
        gs.rp0 = p


def i_alignrp(e, a):
    gs = e.gs
    z0, z1 = e.zp0, e.zp1
    if e.top < gs.loop or gs.rp0 >= z0.n_points:
        gs.loop = 1
        e.new_top = e.args
        return
    st = e.stack
    rx, ry = z0.cx[gs.rp0], z0.cy[gs.rp0]
    while gs.loop > 0:
        e.args -= 1
        p = st[e.args] & 0xFFFF
        if p < z1.n_points:
            d = e.project(z1.cx[p] - rx, z1.cy[p] - ry)
            e.move(z1, p, -d)
        gs.loop -= 1
    gs.loop = 1
    e.new_top = e.args


def i_miap(e, a):
    st = e.stack
    entry = st[a + 1]
    p = st[a] & 0xFFFF
    gs = e.gs
    z = e.zp0
    if p >= z.n_points or _bad(entry, len(e.cvt)):
        gs.rp0 = gs.rp1 = p
        return
    distance = e.cvt[entry]
    if gs.gep0 == 0:
        z.ox[p] = mul_fix14(distance, gs.fv_x)
        z.oy[p] = mul_fix14(distance, gs.fv_y)
        z.cx[p], z.cy[p] = z.ox[p], z.oy[p]
    org_dist = e.project(z.cx[p], z.cy[p])
    if e.opcode & 1:
        if abs(distance - org_dist) > gs.cvt_cutin:
            distance = org_dist
        distance = e.round(distance)
    e.move(z, p, distance - org_dist)
    gs.rp0 = gs.rp1 = p


def i_ws(e, a):
    st = e.stack
    i = st[a]
    if _bad(i, len(e.storage)):
        return
    e._own_storage()
    e.storage[i] = st[a + 1]


def i_rs(e, a):
    st = e.stack
    i = st[a]
    st[a] = 0 if _bad(i, len(e.storage)) else e.storage[i]


def i_wcvtp(e, a):
    st = e.stack
    i = st[a]
    if _bad(i, len(e.cvt)):
        return
    e._own_cvt()
    e.cvt[i] = st[a + 1]


def i_wcvtf(e, a):
    st = e.stack
    i = st[a]
    if _bad(i, len(e.cvt)):
        return
    e._own_cvt()
    e.cvt[i] = mul_fix(st[a + 1], e.scale)


def i_rcvt(e, a):
    st = e.stack
    i = st[a]
    st[a] = 0 if _bad(i, len(e.cvt)) else e.cvt[i]


def i_gc(e, a):
    st = e.stack
    p = st[a]
    z = e.zp2
    if _bad(p, z.n_points):
        st[a] = 0
    elif e.opcode & 1:
        st[a] = e.dual_project(z.ox[p], z.oy[p])
    else:
        st[a] = e.project(z.cx[p], z.cy[p])


def i_scfs(e, a):
    st = e.stack
    p = st[a] & 0xFFFF
    z = e.zp2
    if p >= z.n_points:
        return
    k = e.project(z.cx[p], z.cy[p])
    e.move(z, p, st[a + 1] - k)
    if e.gs.gep2 == 0:
        z.ox[p], z.oy[p] = z.cx[p], z.cy[p]


def i_md(e, a):
    st = e.stack
    k, l = st[a + 1] & 0xFFFF, st[a] & 0xFFFF
    z0, z1 = e.zp0, e.zp1
    if l >= z0.n_points or k >= z1.n_points:
        d = 0
    elif e.opcode & 1:
        d = e.project(z0.cx[l] - z1.cx[k], z0.cy[l] - z1.cy[k])
    elif e.gs.gep0 == 0 or e.gs.gep1 == 0:
        d = e.dual_project(z0.ox[l] - z1.ox[k], z0.oy[l] - z1.oy[k])
    elif e.x_scale == e.y_scale:
        d = mul_fix(e.dual_project(z0.ux[l] - z1.ux[k],
                                   z0.uy[l] - z1.uy[k]), e.x_scale)
    else:
        d = e.dual_project(mul_fix(z0.ux[l] - z1.ux[k], e.x_scale),
                           mul_fix(z0.uy[l] - z1.uy[k], e.y_scale))
    st[a] = d


def i_mppem(e, a):
    e.stack[a] = e.ppem


def i_mps(e, a):
    e.stack[a] = e.point_size


def i_flipon(e, a):
    e.gs.auto_flip = True


def i_flipoff(e, a):
    e.gs.auto_flip = False


def i_debug(e, a):
    raise TTError("Debug_OpCode")


def _compare(fn):
    def handler(e, a):
        st = e.stack
        st[a] = int(fn(st[a], st[a + 1]))
    return handler


def i_odd(e, a):
    """ODD: the rounded value's whole pixels are odd (FreeType tests its
    floor, so a half-grid value counts)."""
    e.stack[a] = int(e.round(e.stack[a]) & 64 != 0)


def i_even(e, a):
    e.stack[a] = int(e.round(e.stack[a]) & 64 == 0)


def i_if(e, a):
    if e.stack[a] != 0:
        return
    n_ifs = 1
    out = False
    while not out:
        e.skip_code()
        op = e.opcode
        if op == 0x58:
            n_ifs += 1
        elif op == 0x1B:
            out = n_ifs == 1
        elif op == 0x59:
            n_ifs -= 1
            out = n_ifs == 0


def i_eif(e, a):
    pass


def i_not(e, a):
    e.stack[a] = int(e.stack[a] == 0)


def i_deltap(e, a):
    st = e.stack
    ppem = e.ppem
    n = st[a] & 0xFFFFFFFFFFFFFFFF        # FT_ULong
    gs = e.gs
    z = e.zp0
    k = 1
    while k <= n:
        if e.args < 2:
            e.args = 0
            break
        e.args -= 2
        point = st[e.args + 1] & 0xFFFF
        b = st[e.args]
        k += 1
        if point >= z.n_points:
            continue
        c = (b & 0xF0) >> 4
        c += {0x5D: 0, 0x71: 16, 0x72: 32}[e.opcode] + gs.delta_base
        if ppem != c:
            continue
        b = (b & 0xF) - 8
        if b >= 0:
            b += 1
        b *= 1 << (6 - gs.delta_shift)
        if e.backward_compatibility:
            if not (e.iupx_called and e.iupy_called) and (
                    (e.is_composite and gs.fv_y != 0)
                    or z.tags[point] & TOUCH_Y):
                e.move(z, point, b)
        else:
            e.move(z, point, b)
    e.new_top = e.args


def i_deltac(e, a):
    st = e.stack
    ppem = e.ppem
    n = st[a] & 0xFFFFFFFFFFFFFFFF        # FT_ULong
    gs = e.gs
    k = 1
    while k <= n:
        if e.args < 2:
            e.args = 0
            break
        e.args -= 2
        entry = st[e.args + 1]
        b = st[e.args]
        k += 1
        if _bad(entry, len(e.cvt)):
            continue
        c = (b & 0xF0) >> 4
        c += {0x73: 0, 0x74: 16, 0x75: 32}[e.opcode] + gs.delta_base
        if ppem != c:
            continue
        b = (b & 0xF) - 8
        if b >= 0:
            b += 1
        b *= 1 << (6 - gs.delta_shift)
        e._own_cvt()
        e.cvt[entry] += b
    e.new_top = e.args


def i_sdb(e, a):
    e.gs.delta_base = e.stack[a] & 0xFFFF


def i_sds(e, a):
    v = e.stack[a]
    if _bad(v, 7):
        raise TTError("Bad_Argument")
    e.gs.delta_shift = v


def _arith(fn):
    def handler(e, a):
        st = e.stack
        st[a] = fn(st[a], st[a + 1])
    return handler


def i_div(e, a):
    st = e.stack
    if st[a + 1] == 0:
        raise TTError("Divide_By_Zero")
    st[a] = mul_div_no_round(st[a], 64, st[a + 1])


def i_mul(e, a):
    st = e.stack
    st[a] = mul_div(st[a], st[a + 1], 64)


def i_abs(e, a):
    e.stack[a] = abs(e.stack[a])


def i_neg(e, a):
    e.stack[a] = -e.stack[a]


def i_floor(e, a):
    e.stack[a] &= -64


def i_ceiling(e, a):
    e.stack[a] = (e.stack[a] + 63) & -64


def i_round(e, a):
    e.stack[a] = e.round(e.stack[a])


def i_nround(e, a):
    pass                                # Round_None, compensation 0


def i_sround(e, a):
    e.set_super_round(0x4000, e.stack[a])
    e.gs.round_state = SUPER


def i_s45round(e, a):
    e.set_super_round(0x2D41, e.stack[a])
    e.gs.round_state = SUPER_45


def i_jrot(e, a):
    if e.stack[a + 1] != 0:
        i_jmpr(e, a)


def i_jrof(e, a):
    if e.stack[a + 1] == 0:
        i_jmpr(e, a)


def i_noop_pop(e, a):                   # SANGW, AA
    pass


def i_flippt(e, a):
    gs = e.gs
    if e.backward_compatibility and e.iupx_called and e.iupy_called:
        gs.loop = 1
        e.new_top = e.args
        return
    if e.top < gs.loop:
        gs.loop = 1
        e.new_top = e.args
        return
    st = e.stack
    z = e.pts
    while gs.loop > 0:
        e.args -= 1
        p = st[e.args] & 0xFFFF
        if p < z.n_points:
            z.tags[p] ^= ON_CURVE
        gs.loop -= 1
    gs.loop = 1
    e.new_top = e.args


def _fliprange(on: bool):
    def handler(e, a):
        if e.backward_compatibility and e.iupx_called and e.iupy_called:
            return
        st = e.stack
        k, l = st[a + 1] & 0xFFFF, st[a] & 0xFFFF
        z = e.pts
        if k >= z.n_points or l >= z.n_points:
            return
        for i in range(l, k + 1):
            if on:
                z.tags[i] |= ON_CURVE
            else:
                z.tags[i] &= ~ON_CURVE
    return handler


def i_scanctrl(e, a):
    v = e.stack[a]
    gs = e.gs
    thr = v & 0xFF
    if thr == 0xFF:
        gs.scan_control = True
        return
    if thr == 0:
        gs.scan_control = False
        return
    if v & 0x100 and e.ppem <= thr:
        gs.scan_control = True
    if v & 0x800 and e.ppem > thr:
        gs.scan_control = False


def i_sdpvtl(e, a):
    st = e.stack
    p1, p2 = st[a + 1] & 0xFFFF, st[a] & 0xFFFF
    if p2 >= e.zp1.n_points or p1 >= e.zp2.n_points:
        return
    gs = e.gs
    x, y = _line_vector(e, p1, p2, e.zp1, e.zp2, True, e.opcode)
    v = normalize(x, y)
    if v is not None:
        gs.dv_x, gs.dv_y = v
    x, y = _line_vector(e, p1, p2, e.zp1, e.zp2, False, e.opcode)
    v = normalize(x, y)
    if v is not None:
        gs.pv_x, gs.pv_y = v
    e.compute_funcs()


def i_getinfo(e, a):
    sel = e.stack[a]
    k = 0
    if sel & 1:
        k = 40
    if sel & 32 and e.grayscale:
        k |= 1 << 12
    if e.subpixel_hinting_lean:          # bit 15, vertical LCD, stays 0
        if sel & 64:
            k |= 1 << 13
        if sel & 1024:
            k |= 1 << 17
        if sel & 2048:
            k |= 1 << 18
        if sel & 4096 and e.grayscale_cleartype:
            k |= 1 << 19
    e.stack[a] = k


def i_idef(e, a):
    if e.ini_range == GLYPH_RANGE:
        raise TTError("DEF_In_Glyf_Bytecode")
    n = e.stack[a]
    d = next((x for x in e.idefs if x.opc == n), None)
    if d is None:
        if len(e.idefs) >= e.max_idefs:
            raise TTError("Too_Many_Instruction_Defs")
        d = _Def()
        e.idefs.append(d)
    if n < 0 or n > 0xFF:
        raise TTError("Too_Many_Instruction_Defs")
    d.opc, d.start, d.range, d.active = n, e.ip + 1, e.cur_range, True
    _skip_definition(e, d)


def i_roll(e, a):
    st = e.stack
    st[a], st[a + 1], st[a + 2] = st[a + 1], st[a + 2], st[a]


def i_scantype(e, a):
    if e.stack[a] >= 0:
        e.gs.scan_type = e.stack[a] & 0xFFFF


def i_instctrl(e, a):
    st = e.stack
    k, l = st[a + 1], st[a]
    if k < 1 or k > 3:
        return
    kf = 1 << (k - 1)
    if l != 0 and l != kf:
        return
    if e.ini_range == CVT_RANGE:
        e.gs.instruct_control = (e.gs.instruct_control & ~kf) | l
    elif e.ini_range == GLYPH_RANGE and k == 3:
        e.backward_compatibility = l != 4


def i_unknown(e, a):
    """An opcode the specification leaves undefined: its IDEF, or an
    Invalid_Opcode error."""
    for d in e.idefs:
        if d.opc == e.opcode and d.active:
            if len(e.call_stack) >= CALL_STACK_SIZE:
                raise TTError("Stack_Overflow")
            e.call_stack.append([e.cur_range, e.ip + 1, 1, d])
            e.goto_range(d.range, d.start)
            e.step_ins = False
            return
    raise TTError("Invalid_Opcode")


def i_push(e, a):
    values = e.values
    e.stack[a:a + len(values)] = values


def i_npush(e, a):
    values = e.values
    n = len(values)
    if _bad(n, e.stack_size + 1 - e.top):
        raise TTError("Stack_Overflow")
    e.stack[e.top:e.top + n] = values
    e.new_top += n


def i_mdrp(e, a):
    st = e.stack
    p = st[a] & 0xFFFF
    gs = e.gs
    z0, z1 = e.zp0, e.zp1
    rp0 = gs.rp0
    if p >= z1.n_points or rp0 >= z0.n_points:
        gs.rp1 = gs.rp0
        gs.rp2 = p
        if e.opcode & 16:
            gs.rp0 = p
        return
    if gs.gep0 == 0 or gs.gep1 == 0:
        org_dist = e.dual_project(z1.ox[p] - z0.ox[rp0],
                                  z1.oy[p] - z0.oy[rp0])
    elif e.x_scale == e.y_scale:
        org_dist = mul_fix(e.dual_project(z1.ux[p] - z0.ux[rp0],
                                          z1.uy[p] - z0.uy[rp0]), e.x_scale)
    else:
        org_dist = e.dual_project(mul_fix(z1.ux[p] - z0.ux[rp0], e.x_scale),
                                  mul_fix(z1.uy[p] - z0.uy[rp0], e.y_scale))
    if (gs.sw_cutin > 0 and org_dist < gs.sw_value + gs.sw_cutin
            and org_dist > gs.sw_value - gs.sw_cutin):
        org_dist = gs.sw_value if org_dist >= 0 else -gs.sw_value
    op = e.opcode
    distance = e.round(org_dist) if op & 4 else org_dist
    if op & 8:
        md = gs.min_dist
        if org_dist >= 0:
            if distance < md:
                distance = md
        elif distance > -md:
            distance = -md
    cur = e.project(z1.cx[p] - z0.cx[rp0], z1.cy[p] - z0.cy[rp0])
    e.move(z1, p, distance - cur)
    gs.rp1 = gs.rp0
    gs.rp2 = p
    if op & 16:
        gs.rp0 = p


def i_mirp(e, a):
    st = e.stack
    p = st[a] & 0xFFFF
    entry = st[a + 1] + 1
    gs = e.gs
    z0, z1 = e.zp0, e.zp1
    rp0 = gs.rp0
    if (p >= z1.n_points or _bad(entry, len(e.cvt) + 1)
            or rp0 >= z0.n_points):
        gs.rp1 = gs.rp0
        if e.opcode & 16:
            gs.rp0 = p
        gs.rp2 = p
        return
    cvt_dist = e.cvt[entry - 1] if entry else 0
    if abs(cvt_dist - gs.sw_value) < gs.sw_cutin:
        cvt_dist = gs.sw_value if cvt_dist >= 0 else -gs.sw_value
    if gs.gep1 == 0:
        z1.ox[p] = z0.ox[rp0] + mul_fix14(cvt_dist, gs.fv_x)
        z1.oy[p] = z0.oy[rp0] + mul_fix14(cvt_dist, gs.fv_y)
        z1.cx[p], z1.cy[p] = z1.ox[p], z1.oy[p]
    org_dist = e.dual_project(z1.ox[p] - z0.ox[rp0], z1.oy[p] - z0.oy[rp0])
    cur_dist = e.project(z1.cx[p] - z0.cx[rp0], z1.cy[p] - z0.cy[rp0])
    if gs.auto_flip and (org_dist ^ cvt_dist) < 0:
        cvt_dist = -cvt_dist
    op = e.opcode
    if op & 4:
        if gs.gep0 == gs.gep1 and abs(cvt_dist - org_dist) > gs.cvt_cutin:
            cvt_dist = org_dist
        distance = e.round(cvt_dist)
    else:
        distance = cvt_dist
    if op & 8:
        md = gs.min_dist
        if org_dist >= 0:
            if distance < md:
                distance = md
        elif distance > -md:
            distance = -md
    e.move(z1, p, distance - cur_dist)
    gs.rp1 = gs.rp0
    if op & 16:
        gs.rp0 = p
    gs.rp2 = p


_HANDLERS = [i_unknown] * 256
for _op in range(6):
    _HANDLERS[_op] = i_svtca
_HANDLERS[0x06] = _HANDLERS[0x07] = i_spvtl
_HANDLERS[0x08] = _HANDLERS[0x09] = i_sfvtl
_HANDLERS[0x0A] = i_spvfs
_HANDLERS[0x0B] = i_sfvfs
_HANDLERS[0x0C] = i_gpv
_HANDLERS[0x0D] = i_gfv
_HANDLERS[0x0E] = i_sfvtpv
_HANDLERS[0x0F] = i_isect
_HANDLERS[0x10] = i_srp0
_HANDLERS[0x11] = i_srp1
_HANDLERS[0x12] = i_srp2
_HANDLERS[0x13] = i_szp0
_HANDLERS[0x14] = i_szp1
_HANDLERS[0x15] = i_szp2
_HANDLERS[0x16] = i_szps
_HANDLERS[0x17] = i_sloop
_HANDLERS[0x18] = _set_round(GRID)
_HANDLERS[0x19] = _set_round(HALF_GRID)
_HANDLERS[0x1A] = i_smd
_HANDLERS[0x1B] = i_else
_HANDLERS[0x1C] = i_jmpr
_HANDLERS[0x1D] = i_scvtci
_HANDLERS[0x1E] = i_sswci
_HANDLERS[0x1F] = i_ssw
_HANDLERS[0x20] = i_dup
_HANDLERS[0x21] = i_pop
_HANDLERS[0x22] = i_clear
_HANDLERS[0x23] = i_swap
_HANDLERS[0x24] = i_depth
_HANDLERS[0x25] = i_cindex
_HANDLERS[0x26] = i_mindex
_HANDLERS[0x27] = i_alignpts
_HANDLERS[0x29] = i_utp
_HANDLERS[0x2A] = i_loopcall
_HANDLERS[0x2B] = i_call
_HANDLERS[0x2C] = i_fdef
_HANDLERS[0x2D] = i_endf
_HANDLERS[0x2E] = _HANDLERS[0x2F] = i_mdap
_HANDLERS[0x30] = _HANDLERS[0x31] = i_iup
_HANDLERS[0x32] = _HANDLERS[0x33] = i_shp
_HANDLERS[0x34] = _HANDLERS[0x35] = i_shc
_HANDLERS[0x36] = _HANDLERS[0x37] = i_shz
_HANDLERS[0x38] = i_shpix
_HANDLERS[0x39] = i_ip
_HANDLERS[0x3A] = _HANDLERS[0x3B] = i_msirp
_HANDLERS[0x3C] = i_alignrp
_HANDLERS[0x3D] = _set_round(DOUBLE_GRID)
_HANDLERS[0x3E] = _HANDLERS[0x3F] = i_miap
_HANDLERS[0x40] = _HANDLERS[0x41] = i_npush
_HANDLERS[0x42] = i_ws
_HANDLERS[0x43] = i_rs
_HANDLERS[0x44] = i_wcvtp
_HANDLERS[0x45] = i_rcvt
_HANDLERS[0x46] = _HANDLERS[0x47] = i_gc
_HANDLERS[0x48] = i_scfs
_HANDLERS[0x49] = _HANDLERS[0x4A] = i_md
_HANDLERS[0x4B] = i_mppem
_HANDLERS[0x4C] = i_mps
_HANDLERS[0x4D] = i_flipon
_HANDLERS[0x4E] = i_flipoff
_HANDLERS[0x4F] = i_debug
_HANDLERS[0x50] = _compare(lambda x, y: x < y)
_HANDLERS[0x51] = _compare(lambda x, y: x <= y)
_HANDLERS[0x52] = _compare(lambda x, y: x > y)
_HANDLERS[0x53] = _compare(lambda x, y: x >= y)
_HANDLERS[0x54] = _compare(lambda x, y: x == y)
_HANDLERS[0x55] = _compare(lambda x, y: x != y)
_HANDLERS[0x56] = i_odd
_HANDLERS[0x57] = i_even
_HANDLERS[0x58] = i_if
_HANDLERS[0x59] = i_eif
_HANDLERS[0x5A] = _compare(lambda x, y: x != 0 and y != 0)
_HANDLERS[0x5B] = _compare(lambda x, y: x != 0 or y != 0)
_HANDLERS[0x5C] = i_not
_HANDLERS[0x5D] = _HANDLERS[0x71] = _HANDLERS[0x72] = i_deltap
_HANDLERS[0x5E] = i_sdb
_HANDLERS[0x5F] = i_sds
_HANDLERS[0x60] = _arith(lambda x, y: x + y)
_HANDLERS[0x61] = _arith(lambda x, y: x - y)
_HANDLERS[0x62] = i_div
_HANDLERS[0x63] = i_mul
_HANDLERS[0x64] = i_abs
_HANDLERS[0x65] = i_neg
_HANDLERS[0x66] = i_floor
_HANDLERS[0x67] = i_ceiling
for _op in range(0x68, 0x6C):
    _HANDLERS[_op] = i_round
for _op in range(0x6C, 0x70):
    _HANDLERS[_op] = i_nround
_HANDLERS[0x70] = i_wcvtf
_HANDLERS[0x73] = _HANDLERS[0x74] = _HANDLERS[0x75] = i_deltac
_HANDLERS[0x76] = i_sround
_HANDLERS[0x77] = i_s45round
_HANDLERS[0x78] = i_jrot
_HANDLERS[0x79] = i_jrof
_HANDLERS[0x7A] = _set_round(OFF)
_HANDLERS[0x7C] = _set_round(UP_TO_GRID)
_HANDLERS[0x7D] = _set_round(DOWN_TO_GRID)
_HANDLERS[0x7E] = _HANDLERS[0x7F] = i_noop_pop
_HANDLERS[0x80] = i_flippt
_HANDLERS[0x81] = _fliprange(True)
_HANDLERS[0x82] = _fliprange(False)
_HANDLERS[0x85] = i_scanctrl
_HANDLERS[0x86] = _HANDLERS[0x87] = i_sdpvtl
_HANDLERS[0x88] = i_getinfo
_HANDLERS[0x89] = i_idef
_HANDLERS[0x8A] = i_roll
_HANDLERS[0x8B] = _arith(max)
_HANDLERS[0x8C] = _arith(min)
_HANDLERS[0x8D] = i_scantype
_HANDLERS[0x8E] = i_instctrl
for _op in range(0xB0, 0xC0):
    _HANDLERS[_op] = i_push
for _op in range(0xC0, 0xE0):
    _HANDLERS[_op] = i_mdrp
for _op in range(0xE0, 0x100):
    _HANDLERS[_op] = i_mirp


# ---------------------------------------------------------------------------
# the font program, the control value program and glyph programs
# ---------------------------------------------------------------------------


class SizeState:
    """What ``prep`` left at one size: the graphics state every glyph
    program starts from, the CVT, the storage, the twilight zone, the
    function and instruction definitions and the super-round parameters;
    ``error`` names the error that stopped ``prep``, if one did."""

    __slots__ = ("ppem", "scale", "gs", "cvt", "storage", "twilight",
                 "fdefs", "num_fdefs", "max_func", "idefs", "rounding",
                 "error")


def _copy_defs(fdefs: Dict[int, _Def], idefs: List[_Def]):
    def dup(d: _Def) -> _Def:
        c = _Def()
        c.range, c.opc, c.start, c.end, c.active = (d.range, d.opc, d.start,
                                                    d.end, d.active)
        return c
    return {k: dup(v) for k, v in fdefs.items()}, [dup(d) for d in idefs]


class FontHinting:
    """One font's hinting: ``fpgm`` run once (at ppem 0, as FreeType runs
    it for a new size), ``prep`` once a size, glyph programs on demand."""

    def __init__(self, *, cvt: List[int], fpgm: bytes, prep: bytes,
                 max_stack: int, max_storage: int, max_twilight: int,
                 max_fdefs: int, max_idefs: int):
        self.cvt_units = list(cvt)
        self.max_storage = max_storage
        self.n_twilight = max_twilight + 4
        e = self.e = Interpreter(stack_size=max_stack + 32,
                                 max_fdefs=max_fdefs, max_idefs=max_idefs,
                                 fpgm=fpgm, prep=prep)
        # the context of a new size: flags still zero
        e.grayscale = e.subpixel_hinting_lean = False
        e.grayscale_cleartype = False
        e.cvt = [0] * len(cvt)
        e.storage = [0] * max_storage
        e.twilight = Zone(self.n_twilight)
        self.fpgm_error = e.run(FONT_RANGE) if fpgm else None
        self.after_fpgm = (_copy_defs(e.fdefs, e.idefs), e.num_fdefs,
                           e.max_func, (e.period, e.phase, e.threshold))
        e.subpixel_hinting_lean = e.grayscale_cleartype = True
        self.sizes: Dict[int, SizeState] = {}

    def size(self, ppem: int, scale: int) -> SizeState:
        """The state ``prep`` leaves at ``ppem`` px (16.16 ``scale``),
        computed once."""
        got = self.sizes.get(ppem)
        if got is not None:
            return got
        e = self.e
        (fdefs, idefs), e.num_fdefs, e.max_func, rounding = self.after_fpgm
        e.fdefs, e.idefs = _copy_defs(fdefs, idefs)
        e.period, e.phase, e.threshold = rounding
        e.gs = GraphicsState()
        e.cvt = [mul_fix(v, scale) for v in self.cvt_units]
        e.storage = [0] * self.max_storage
        e.twilight = Zone(self.n_twilight)
        e.pts = e.zp0 = e.zp1 = e.zp2 = _EMPTY
        e.ppem, e.point_size = ppem, ppem * 64
        e.scale = e.x_scale = e.y_scale = scale
        e.backward_compatibility = e.is_composite = False
        error = e.run(CVT_RANGE) if e.ranges[CVT_RANGE] else None
        gs = e.gs
        # prep may not change these (FreeType's undocumented rule)
        gs.dv_x = gs.pv_x = gs.fv_x = 0x4000
        gs.dv_y = gs.pv_y = gs.fv_y = 0
        gs.rp0 = gs.rp1 = gs.rp2 = 0
        gs.gep0 = gs.gep1 = gs.gep2 = 1
        gs.loop = 1
        s = SizeState()
        s.ppem, s.scale, s.gs = ppem, scale, gs
        s.cvt, s.storage, s.twilight = e.cvt, e.storage, e.twilight
        s.fdefs, s.idefs = e.fdefs, e.idefs
        s.num_fdefs, s.max_func = e.num_fdefs, e.max_func
        s.rounding = (e.period, e.phase, e.threshold)
        s.error = self.fpgm_error or error
        if gs.instruct_control & 2:           # default state for glyphs
            s.gs = GraphicsState()
            s.gs.instruct_control = gs.instruct_control
        self.sizes[ppem] = s
        return s

    def start_glyph(self, s: SizeState) -> None:
        """Set up a glyph load at size ``s`` (``tt_loader_init``): backward
        compatibility unless ``prep`` set INSTCTRL selector 3."""
        self.e.backward_compatibility = not s.gs.instruct_control & 4

    def hint(self, s: SizeState, zone: Zone, program: Optional[Program],
             is_composite: bool) -> bool:
        """``TT_Hint_Glyph``: round the phantom points and run the glyph
        program on ``zone`` (points, then the four phantom points);
        whether backward compatibility is still on after it."""
        e = self.e
        n = zone.n_points
        if program is not None:
            zone.ox, zone.oy = zone.cx[:], zone.cy[:]
        if is_composite:
            zone.ux, zone.uy = zone.cx[:], zone.cy[:]
        cx, cy = zone.cx, zone.cy
        cx[n - 4] = (cx[n - 4] + 32) & -64
        cx[n - 3] = (cx[n - 3] + 32) & -64
        cy[n - 2] = (cy[n - 2] + 32) & -64
        cy[n - 1] = (cy[n - 1] + 32) & -64
        if program is not None:
            gs = e.gs = s.gs.copy()
            gs.gep0 = gs.gep1 = gs.gep2 = 1
            gs.pv_x = gs.fv_x = gs.dv_x = 0x4000
            gs.pv_y = gs.fv_y = gs.dv_y = 0
            gs.round_state = GRID
            gs.loop = 1
            e.cvt, e.storage, e.twilight = s.cvt, s.storage, s.twilight.copy()
            e.fdefs, e.idefs = s.fdefs, s.idefs
            e.num_fdefs, e.max_func = s.num_fdefs, s.max_func
            e.period, e.phase, e.threshold = s.rounding
            e.ppem, e.point_size, e.scale = s.ppem, s.ppem * 64, s.scale
            e.x_scale = e.y_scale = 0x10000 if is_composite else s.scale
            e.is_composite = is_composite
            e.pts = e.zp0 = e.zp1 = e.zp2 = zone
            e.ranges[GLYPH_RANGE] = program
            e.run(GLYPH_RANGE)
        return e.backward_compatibility
