"""JPEG decoding, and the JPEG round trip, in numpy, equal to what the JAX
package gets from cv2.

:func:`read_jpeg` returns what ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` returns: an (H, W, 3) uint8 RGB
image, byte for byte. cv2 decodes through libjpeg-turbo with its defaults,
so this module follows that library's C code rather than a textbook:

* the entropy decoders of ``jdhuff.c`` (sequential) and ``jdphuff.c``
  (progressive: DC first and refinement, AC first with EOB runs, AC
  refinement), table driven: one 16-bit lookahead table a Huffman table
  gives each code's symbol and length in one lookup, and the bit stream
  is read through a precomputed window of the 16 bits at every position;
* the ``JDCT_ISLOW`` integer inverse DCT of ``jidctint.c``
  (``CONST_BITS`` 13, ``PASS1_BITS`` 2, the range-limit table of
  ``jdmaster.c``), vectorised over all blocks in int64;
* the fancy upsampling of ``jdsample.c`` (h2v1, h1v2 and h2v2 with their
  alternating rounding biases, edge replication at the component's
  downsampled size, box replication where the library picks it for
  components two samples wide or less);
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (``SCALEBITS`` 16);
* cv2's EXIF orientation (tag 0x0112 of the first Exif APP1, values
  1-8).

Supported: baseline (SOF0), extended 8-bit Huffman (SOF1) and progressive
(SOF2) frames; 1 (gray, replicated into three channels) or 3 components at
sampling factors 1-2; restart intervals; any Huffman tables. Anything else
(arithmetic coding, 12-bit samples, lossless or hierarchical frames, CMYK
or YCCK, sampling factors above 2 such as 4:1:1, a progressive file whose
scans stop before its coefficients are complete, a file without its EOI
marker) raises a ``ValueError`` that names the file; a file that libjpeg
refuses too (no frame or scan, bad tables) raises :class:`CorruptImage`.
The entropy decoding is a Python loop on the host.

:func:`jpeg_roundtrip_u8` is ``cv2.imdecode(cv2.imencode(".jpg", ...))``
at a quality, byte for byte: :func:`encode_coefficients` computes the
quantized coefficients libjpeg-turbo's encoder writes with cv2's defaults
(``jccolor.c``, ``jcsample.c`` / ``jcprepct.c``, ``jfdctint.c``,
``jcdctmgr.c``, ``jcparam.c``, ``jccoefct.c``), and the decoder's output
stage (:func:`samples_to_rgb`) turns them into pixels. Huffman coding is
lossless, so neither side runs it.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

import numpy as np

from marconet_tpu_torch.utils.png import CorruptImage

# zigzag position -> natural (row-major) index, padded as libjpeg pads
# ``jpeg_natural_order`` so that a corrupt run cannot index past the block
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] \
    + [63] * 16

_UNSUPPORTED_SOF = {0xC3: "lossless", 0xC5: "hierarchical",
                    0xC6: "hierarchical", 0xC7: "hierarchical lossless",
                    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
                    0xCB: "arithmetic-coded lossless",
                    0xCD: "arithmetic-coded hierarchical",
                    0xCE: "arithmetic-coded hierarchical",
                    0xCF: "arithmetic-coded hierarchical lossless"}
# libjpeg-turbo's smoothing_ok() looks at this many coefficients of a
# progressive image (SAVED_COEFS)
_SMOOTHING_COEFS = 10


def _range_limit() -> np.ndarray:
    """``jdmaster.c``'s post-IDCT range-limit table, indexed by a value &
    1023: v + 128 clamped to 0..255 for |v| < 512."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0],
                     x - 896).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def _color_tables():
    """``jdcolor.c::build_ycc_rgb_table`` (``SCALEBITS`` 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix(1.40200) * x + half) >> 16
    cb_b = (_fix(1.77200) * x + half) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coef: Optional[list] = None
        self.quant: Optional[np.ndarray] = None     # latched at first scan
        self.bits = [-1] * 64                       # progressive coef_bits


def _huffman_lut(counts: bytes, symbols: bytes, name: str) -> list:
    """A 65536-entry lookahead table: the 16 bits at the read position ->
    (code length << 8) | symbol, -1 for a prefix that is no code."""
    lut = np.full(1 << 16, -1, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise CorruptImage(f"{name}: bad Huffman table")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = \
                (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data of a scan from ``pos``: its restart
    intervals with stuffed bytes removed, and the position of the marker
    that ends it."""
    segments, cur, n = [], bytearray(), len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            cur += data[pos:]
            end = n
            break
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:                 # fill byte
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:         # RSTn
            segments.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            end = j
            break
    segments.append(bytes(cur))
    return segments, end


def _bit_window(segments: List[bytes]) -> Tuple[list, List[int]]:
    """The 16 bits starting at every bit position of the concatenated
    segments (zeros past the end, as libjpeg fills), and each segment's
    first bit position."""
    starts, total = [], 0
    for s in segments:
        starts.append(total * 8)
        total += len(s)
    b = np.frombuffer(b"".join(segments) + b"\0" * 8, np.uint8) \
        .astype(np.uint32)
    w32 = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    shifts = (16 - np.arange(8)).astype(np.uint32)
    win = ((w32[:, None] >> shifts) & 0xFFFF).reshape(-1)
    return win.tolist(), starts


def _idct_1d(c):
    """The even / odd butterflies of ``jpeg_idct_islow`` on one pass;
    returns the eight outputs before descaling."""
    z1 = (c[2] + c[6]) * 4433                      # FIX_0_541196100
    tmp2 = z1 + c[6] * -15137                      # FIX_1_847759065
    tmp3 = z1 + c[2] * 6270                        # FIX_0_765366865
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                          # FIX_1_175875602
    t0 = t0 * 2446                                 # FIX_0_298631336
    t1 = t1 * 16819                                # FIX_2_053119869
    t2 = t2 * 25172                                # FIX_3_072711026
    t3 = t3 * 12299                                # FIX_1_501321110
    z1 = z1 * -7373                                # FIX_0_899976223
    z2 = z2 * -20995                               # FIX_2_562915447
    z3 = z3 * -16069 + z5                          # FIX_1_961570560
    z4 = z4 * -3196 + z5                           # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jidctint.c::jpeg_idct_islow`` over blocks: (..., 64) coefficients
    in natural order and a (64,) quantization table -> (..., 8, 8) uint8
    samples."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)) \
        .reshape(-1, 8, 8)
    # pass 1: columns (index rows of the block), descale by 11
    ws = _idct_1d([x[:, k, :] for k in range(8)])
    ws = np.stack([(v + (1 << 10)) >> 11 for v in ws], axis=1)
    # pass 2: rows, descale by 18 and range-limit
    out = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([(v + (1 << 17)) >> 18 for v in out], axis=2)
    return _RANGE_LIMIT[out & 1023].reshape(coef.shape[:-1] + (8, 8))


def _edge(a: np.ndarray, axis: int, before: bool) -> np.ndarray:
    """``a`` shifted by one along ``axis`` with its edge replicated: the
    previous (``before``) or next neighbour of every sample."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + (-1 if before else 1), 0, n - 1)
    return np.take(a, idx, axis=axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """``jdsample.c``'s upsampling of one component at its downsampled
    size (dh, dw) by (rv, rh): fancy h2v1 / h1v2 / h2v2, box replication
    where libjpeg-turbo takes it (h2 with dw <= 2)."""
    p = plane.astype(np.int32)
    dw = p.shape[1]
    if rh == 2 and dw <= 2:            # h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(plane, rh, axis=1), rv, axis=0)
    if rv == 2:
        near3 = 3 * p
        if rh == 1:                    # h1v2_fancy_upsample
            return _interleave((near3 + _edge(p, 0, True) + 1) >> 2,
                               (near3 + _edge(p, 0, False) + 2) >> 2,
                               0).astype(np.uint8)
        # h2v2_fancy_upsample: column sums of the nearer and farther row
        p = _interleave(near3 + _edge(p, 0, True), near3 + _edge(p, 0, False),
                        0)
        near3 = 3 * p
        return _interleave((near3 + _edge(p, 1, True) + 8) >> 4,
                           (near3 + _edge(p, 1, False) + 7) >> 4,
                           1).astype(np.uint8)
    if rh == 2:                        # h2v1_fancy_upsample
        near3 = 3 * p
        return _interleave((near3 + _edge(p, 1, True) + 1) >> 2,
                           (near3 + _edge(p, 1, False) + 2) >> 2,
                           1).astype(np.uint8)
    return plane


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
               ) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert`` on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _orientation(app1: bytes) -> int:
    """The EXIF orientation (tag 0x0112 of IFD0) of an APP1 payload, 1
    when there is none."""
    if not app1.startswith(b"Exif\0\0") or len(app1) < 14:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            e = ifd + 2 + 12 * i
            tag, typ = struct.unpack(order + "HH", tiff[e:e + 4])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation`` for EXIF values 1-8 (others are
    left as they are)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


class _Decoder:
    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.quant = [None] * 4
        self.dc_luts: list = [None] * 4
        self.ac_luts: list = [None] * 4
        self.restart = 0
        self.comps: List[_Component] = []
        self.progressive = False
        self.exif: Optional[bytes] = None
        self.jfif = False
        self.adobe: Optional[int] = None
        self.eoi = False

    def fail(self, why: str):
        raise ValueError(f"{self.name}: {why}")

    def corrupt(self, why: str):
        """A file libjpeg refuses too (cv2.imread returns None)."""
        raise CorruptImage(f"{self.name}: {why}")

    # -- markers -------------------------------------------------------------

    def decode(self) -> np.ndarray:
        self.parse()
        return apply_orientation(self._output(),
                                 _orientation(self.exif or b""))

    def parse(self) -> None:
        """Read every marker and scan up to EOI: the frame, the tables and
        each component's coefficients."""
        data = self.data
        if not data.startswith(b"\xff\xd8"):
            self.corrupt("not a JPEG file")
        pos = 2
        while not self.eoi:
            while pos < len(data) and data[pos] != 0xFF:
                pos += 1                # garbage between markers (warned)
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                self.fail("truncated JPEG (no EOI marker)")
            marker = data[pos]
            pos += 1
            if marker == 0xD9:
                self.eoi = True
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if pos + 2 > len(data):
                self.fail("truncated JPEG marker")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            if len(body) != length - 2:
                self.fail("truncated JPEG marker segment")
            pos += length
            if marker in (0xC0, 0xC1, 0xC2):
                self._sof(marker, body)
            elif marker in _UNSUPPORTED_SOF:
                self.fail(f"{_UNSUPPORTED_SOF[marker]} JPEG is not "
                          "supported")
            elif marker == 0xCC:
                self.fail("arithmetic-coded JPEG is not supported")
            elif marker == 0xC4:
                self._dht(body)
            elif marker == 0xDB:
                self._dqt(body)
            elif marker == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif marker == 0xDA:
                pos = self._sos(body, pos)
            elif marker == 0xE0 and body.startswith(b"JFIF\0"):
                self.jfif = True
            elif marker == 0xE1 and self.exif is None \
                    and body.startswith(b"Exif\0\0"):
                self.exif = body
            elif marker == 0xEE and body.startswith(b"Adobe") \
                    and len(body) >= 12:
                self.adobe = body[11]
        if not self.comps or self.comps[0].coef is None:
            self.corrupt("JPEG without image data")

    def _sof(self, marker: int, body: bytes) -> None:
        if self.comps:
            self.corrupt("JPEG with two frames")
        precision, h, w, nc = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            self.fail(f"{precision}-bit JPEG is not supported")
        if h == 0 or w == 0:
            self.fail("JPEG without a height (DNL) is not supported")
        if nc == 4:
            self.fail("CMYK / YCCK JPEG is not supported")
        if nc not in (1, 3):
            self.corrupt(f"JPEG with {nc} components")
        self.progressive = marker == 0xC2
        self.height, self.width = h, w
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if hs not in (1, 2) or vs not in (1, 2):
                self.fail(f"JPEG sampling factors {hs}x{vs} are not "
                          "supported (1 or 2 only; not 4:1:1)")
            self.comps.append(_Component(cid, hs, vs, tq & 3))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcus_x = -(-w // (8 * self.hmax))
        self.mcus_y = -(-h // (8 * self.vmax))
        for c in self.comps:
            c.bw, c.bh = self.mcus_x * c.h, self.mcus_y * c.v
            c.dw = -(-w * c.h // self.hmax)     # downsampled_width
            c.dh = -(-h * c.v // self.vmax)
            c.coef = [0] * (c.bw * c.bh * 64)

    def _dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = body[pos + 1:pos + 17]
            n = sum(counts)
            symbols = body[pos + 17:pos + 17 + n]
            if len(counts) != 16 or len(symbols) != n or n > 256:
                self.corrupt("bad Huffman table")
            lut = _huffman_lut(counts, symbols, self.name)
            (self.ac_luts if tc_th >> 4 else self.dc_luts)[tc_th & 3] = lut
            pos += 17 + n

    def _dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 3
            size = 128 if pq else 64
            raw = body[pos + 1:pos + 1 + size]
            if len(raw) != size:
                self.corrupt("bad quantization table")
            q = np.frombuffer(raw, ">u2" if pq else np.uint8) \
                .astype(np.int64)
            table = np.zeros(64, np.int64)
            table[NATURAL[:64]] = q
            self.quant[tq] = table
            pos += 1 + size

    # -- scans ---------------------------------------------------------------

    def _sos(self, body: bytes, pos: int) -> int:
        if not self.comps:
            self.corrupt("JPEG scan before its frame header")
        ns = body[0]
        by_id = {c.id: c for c in self.comps}
        comps, tables = [], []
        for i in range(ns):
            cid, tt = body[1 + 2 * i:3 + 2 * i]
            if cid not in by_id:
                self.corrupt("JPEG scan names an unknown component")
            comps.append(by_id[cid])
            tables.append((tt >> 4, tt & 15))
        ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        for c in comps:
            if c.quant is None:
                if self.quant[c.tq] is None:
                    self.corrupt("JPEG component without quantization "
                                 "table")
                c.quant = self.quant[c.tq]
        segments, end = _entropy_segments(self.data, pos)
        win, starts = _bit_window(segments)
        try:
            self._scan(comps, tables, win, starts, ss, se, ah, al)
        except IndexError:
            self.fail("corrupt JPEG data (entropy data overrun)")
        return end

    def _scan(self, comps, tables, win, starts, ss, se, ah, al) -> None:
        ns = len(comps)
        if not self.progressive:
            if (ss, se, ah, al) != (0, 63, 0, 0):
                self.corrupt("bad sequential JPEG scan parameters")
            self._scan_sequential(comps, tables, win, starts)
        else:
            if ss == 0:
                if se != 0:
                    self.corrupt("bad progressive JPEG scan parameters")
                self._scan_dc(comps, tables, win, starts, ah, al)
            else:
                if ns != 1 or se < ss or se > 63:
                    self.corrupt("bad progressive JPEG scan parameters")
                self._scan_ac(comps[0], tables[0][1], win, starts, ss, se,
                              ah, al)
            for c in comps:
                for k in range(ss, se + 1):
                    c.bits[k] = al

    def _order(self, comps: List[_Component]):
        """(component index in scan, first coefficient index) of every
        block in scan order, and the blocks of one MCU."""
        if len(comps) == 1:
            c = comps[0]
            rows, cols = -(-c.dh // 8), -(-c.dw // 8)
            return [(0, (r * c.bw + x) * 64) for r in range(rows)
                    for x in range(cols)], 1
        order = []
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                for i, c in enumerate(comps):
                    for y in range(c.v):
                        row = (my * c.v + y) * c.bw
                        for x in range(c.h):
                            order.append((i, (row + mx * c.h + x) * 64))
        return order, sum(c.h * c.v for c in comps)

    def _luts(self, luts: list, index: int) -> list:
        lut = luts[index]
        if lut is None:
            self.corrupt("JPEG scan uses an undefined Huffman table")
        return lut

    def _scan_sequential(self, comps, tables, win, starts) -> None:
        order, per_mcu = self._order(comps)
        dcs = [self._luts(self.dc_luts, td) for td, _ in tables]
        acs = [self._luts(self.ac_luts, ta) for _, ta in tables]
        coefs = [c.coef for c in comps]
        natural = NATURAL
        preds = [0] * len(comps)
        interval = self.restart * per_mcu
        pos, seg = starts[0], 0
        for n, (ci, base) in enumerate(order):
            if interval and n and n % interval == 0:
                seg = min(seg + 1, len(starts) - 1)
                pos, preds = starts[seg], [0] * len(comps)
            blk = coefs[ci]
            t = dcs[ci][win[pos]]
            if t < 0:
                self.fail("corrupt JPEG data (bad Huffman code)")
            pos += t >> 8
            s = t & 255
            if s:
                r = win[pos] >> (16 - s)
                pos += s
                if r < (1 << (s - 1)):
                    r += (-1 << s) + 1
                preds[ci] += r
            blk[base] = preds[ci]
            ac = acs[ci]
            k = 1
            while k < 64:
                t = ac[win[pos]]
                if t < 0:
                    self.fail("corrupt JPEG data (bad Huffman code)")
                pos += t >> 8
                s = t & 15
                if s:
                    k += (t >> 4) & 15
                    r = win[pos] >> (16 - s)
                    pos += s
                    if r < (1 << (s - 1)):
                        r += (-1 << s) + 1
                    blk[base + natural[k]] = r
                    k += 1
                elif (t & 255) == 0xF0:
                    k += 16
                else:
                    break

    def _scan_dc(self, comps, tables, win, starts, ah, al) -> None:
        order, per_mcu = self._order(comps)
        coefs = [c.coef for c in comps]
        interval = self.restart * per_mcu
        pos, seg = starts[0], 0
        if ah == 0:                                 # DC first
            dcs = [self._luts(self.dc_luts, td) for td, _ in tables]
            preds = [0] * len(comps)
            for n, (ci, base) in enumerate(order):
                if interval and n and n % interval == 0:
                    seg = min(seg + 1, len(starts) - 1)
                    pos, preds = starts[seg], [0] * len(comps)
                t = dcs[ci][win[pos]]
                if t < 0:
                    self.fail("corrupt JPEG data (bad Huffman code)")
                pos += t >> 8
                s = t & 255
                if s:
                    r = win[pos] >> (16 - s)
                    pos += s
                    if r < (1 << (s - 1)):
                        r += (-1 << s) + 1
                    preds[ci] += r
                coefs[ci][base] = preds[ci] << al
        else:                                       # DC refinement
            p1 = 1 << al
            for n, (ci, base) in enumerate(order):
                if interval and n and n % interval == 0:
                    seg = min(seg + 1, len(starts) - 1)
                    pos = starts[seg]
                if win[pos] & 0x8000:
                    coefs[ci][base] |= p1
                pos += 1

    def _scan_ac(self, comp, table, win, starts, ss, se, ah, al) -> None:
        order, _ = self._order([comp])
        ac = self._luts(self.ac_luts, table)
        blk = comp.coef
        natural = NATURAL
        interval = self.restart
        pos, seg, eobrun = starts[0], 0, 0
        if ah == 0:                                 # AC first
            for n, (_, base) in enumerate(order):
                if interval and n and n % interval == 0:
                    seg = min(seg + 1, len(starts) - 1)
                    pos, eobrun = starts[seg], 0
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    t = ac[win[pos]]
                    if t < 0:
                        self.fail("corrupt JPEG data (bad Huffman code)")
                    pos += t >> 8
                    r, s = (t >> 4) & 15, t & 15
                    if s:
                        k += r
                        v = win[pos] >> (16 - s)
                        pos += s
                        if v < (1 << (s - 1)):
                            v += (-1 << s) + 1
                        blk[base + natural[k]] = v << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[pos] >> (16 - r)
                            pos += r
                        eobrun -= 1
                        break
                    k += 1
            return
        p1, m1 = 1 << al, -1 << al                  # AC refinement
        for n, (_, base) in enumerate(order):
            if interval and n and n % interval == 0:
                seg = min(seg + 1, len(starts) - 1)
                pos, eobrun = starts[seg], 0
            k = ss
            if eobrun == 0:
                while k <= se:
                    t = ac[win[pos]]
                    if t < 0:
                        self.fail("corrupt JPEG data (bad Huffman code)")
                    pos += t >> 8
                    r, s = (t >> 4) & 15, t & 15
                    if s:
                        s = p1 if win[pos] & 0x8000 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[pos] >> (16 - r)
                            pos += r
                        break
                    # skip the already-nonzero coefficients and r zero
                    # ones, appending a correction bit to each nonzero one
                    while k <= se:
                        i = base + natural[k]
                        c = blk[i]
                        if c:
                            if win[pos] & 0x8000 and not c & p1:
                                blk[i] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        blk[base + natural[k]] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    i = base + natural[k]
                    c = blk[i]
                    if c:
                        if win[pos] & 0x8000 and not c & p1:
                            blk[i] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    k += 1
                eobrun -= 1

    # -- output --------------------------------------------------------------

    def _output(self) -> np.ndarray:
        if self.progressive:
            for c in self.comps:
                if any(b != 0 for b in c.bits[:_SMOOTHING_COEFS]):
                    self.fail("progressive JPEG whose scans leave "
                              "coefficients incomplete (libjpeg would "
                              "smooth its blocks) is not supported")
        ids = [c.id for c in self.comps]
        stored_rgb = (not self.jfif and self.adobe == 0) or \
            (not self.jfif and self.adobe is None and ids == [82, 71, 66])
        return samples_to_rgb(self.coefficients(),
                              [c.quant for c in self.comps],
                              [(c.h, c.v) for c in self.comps],
                              self.height, self.width, ycc=not stored_rgb)

    def coefficients(self) -> List[np.ndarray]:
        """Each component's quantized coefficients, (bh, bw, 64) int64 in
        natural order over its MCU-padded block grid."""
        return [np.array(c.coef, np.int64).reshape(c.bh, c.bw, 64)
                for c in self.comps]


def samples_to_rgb(coefs: List[np.ndarray], quants: List[np.ndarray],
                   factors: List[Tuple[int, int]], height: int, width: int,
                   ycc: bool = True) -> np.ndarray:
    """The decoder's output stage: each component's (bh, bw, 64)
    coefficients through :func:`idct_islow` with its quantization table,
    cropped to its downsampled size, upsampled (:func:`upsample`) by its
    (h, v) sampling factors, cropped to (height, width), then
    :func:`ycc_to_rgb` (``ycc``) or taken as stored -> (H, W, 3) uint8 (one
    component: gray replicated into three channels)."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    planes = []
    for coef, quant, (h, v) in zip(coefs, quants, factors):
        bh, bw = coef.shape[:2]
        blocks = idct_islow(coef, quant)                # (bh, bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        plane = plane[:-(-height * v // vmax), :-(-width * h // hmax)]
        full = upsample(plane, hmax // h, vmax // v)
        planes.append(full[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if not ycc:
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def read_jpeg(source: Union[str, bytes]) -> np.ndarray:
    """An (H, W, 3) uint8 RGB image from a JPEG file path or its bytes
    (see the module docstring for what is accepted)."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return decode_jpeg(bytes(source))
    with open(source, "rb") as f:
        return decode_jpeg(f.read(), str(source))


def decode_jpeg(data: bytes, name: str = "<JPEG bytes>") -> np.ndarray:
    """:func:`read_jpeg` of a file's bytes; ``name`` names it in errors."""
    return _Decoder(data, name).decode()


def jpeg_coefficients(data: bytes, name: str = "<JPEG bytes>"
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The quantized coefficients a file stores, as the decoder reads them:
    each component's (bh, bw, 64) int64 array in natural order over its
    MCU-padded block grid, and its (64,) quantization table."""
    dec = _Decoder(data, name)
    dec.parse()
    return dec.coefficients(), [c.quant for c in dec.comps]


# ---------------------------------------------------------------------------
# the encoder: libjpeg-turbo's quantized coefficients for what cv2.imencode
# writes by default (baseline, 4:2:0, the standard tables scaled by quality)
# ---------------------------------------------------------------------------

# jcparam.c's std_luminance_quant_tbl / std_chrominance_quant_tbl, natural
# order
_STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_CHROMA = np.full(64, 99, np.int64)
_STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """``jcparam.c::jpeg_set_quality(quality, force_baseline=TRUE)``: the
    luminance and chrominance tables, (64,) int64 in natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q     # jpeg_quality_scaling
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA, _STD_CHROMA))


def _encode_tables():
    """``jccolor.c::rgb_ycc_start`` (``SCALEBITS`` 16): per-channel terms
    of Y, Cb and Cr, each (3, 256) int64 for R, G, B."""
    x = np.arange(256, dtype=np.int64)
    half, offset = 1 << 15, 128 << 16
    y = np.stack([_fix(0.29900) * x, _fix(0.58700) * x,
                  _fix(0.11400) * x + half])
    cb = np.stack([-_fix(0.16874) * x, -_fix(0.33126) * x,
                   _fix(0.50000) * x + offset + half - 1])
    cr = np.stack([_fix(0.50000) * x + offset + half - 1,
                   -_fix(0.41869) * x, -_fix(0.08131) * x])
    return y, cb, cr


_RGB_YCC = _encode_tables()


def _fdct_1d(d, shift1: int, shift2: int):
    """One pass of ``jfdctint.c::jpeg_fdct_islow`` over eight sample
    arrays: the even outputs 0 / 4 scaled by 2 ** ``shift1`` (negative:
    descaled), the rest descaled by ``shift2`` bits."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    if shift1 >= 0:
        out0, out4 = (tmp10 + tmp11) << shift1, (tmp10 - tmp11) << shift1
    else:
        out0 = descale(tmp10 + tmp11, -shift1)
        out4 = descale(tmp10 - tmp11, -shift1)
    z1 = (tmp12 + tmp13) * 4433                    # FIX_0_541196100
    out2 = descale(z1 + tmp13 * 6270, shift2)      # FIX_0_765366865
    out6 = descale(z1 + tmp12 * -15137, shift2)    # FIX_1_847759065
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633                          # FIX_1_175875602
    tmp4 = tmp4 * 2446                             # FIX_0_298631336
    tmp5 = tmp5 * 16819                            # FIX_2_053119869
    tmp6 = tmp6 * 25172                            # FIX_3_072711026
    tmp7 = tmp7 * 12299                            # FIX_1_501321110
    z1 = z1 * -7373                                # FIX_0_899976223
    z2 = z2 * -20995                               # FIX_2_562915447
    z3 = z3 * -16069 + z5                          # FIX_1_961570560
    z4 = z4 * -3196 + z5                           # FIX_0_390180644
    return [out0, descale(tmp7 + z1 + z4, shift2), out2,
            descale(tmp6 + z2 + z3, shift2), out4,
            descale(tmp5 + z2 + z4, shift2), out6,
            descale(tmp4 + z1 + z3, shift2)]


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c::convsamp`` (level shift by 128) and
    ``jfdctint.c::jpeg_fdct_islow`` over (..., 8, 8) samples -> (..., 64)
    int64 coefficients in natural order, scaled up by 8."""
    x = blocks.astype(np.int64).reshape(-1, 8, 8) - 128
    # pass 1: rows, scaled up by 2 ** PASS1_BITS
    ws = _fdct_1d([x[:, :, k] for k in range(8)], 2, 13 - 2)
    ws = np.stack(ws, axis=2)
    # pass 2: columns, PASS1_BITS removed
    out = _fdct_1d([ws[:, k, :] for k in range(8)], -2, 13 + 2)
    return np.stack(out, axis=1).reshape(blocks.shape[:-2] + (64,))


def quantize(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c::quantize``: each coefficient over ``quant << 3``,
    rounded half away from zero. libjpeg-turbo multiplies by a reciprocal
    with a corrected rounding term; its quotients are these (checked over
    every divisor and every value the DCT can give in
    ``tests/test_torch_jpeg_encode.py``)."""
    d = quant.astype(np.int64) << 3
    q = (np.abs(coef) + (d >> 1)) // d
    return np.where(coef < 0, -q, q)


def _edge_pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``plane`` replicated at its bottom and right edges out to
    (rows, cols) (``jcsample.c::expand_right_edge``,
    ``jcprepct.c::expand_bottom_edge``)."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 * bh, 8 * bw) samples -> (bh, bw, 8, 8) blocks."""
    rows, cols = plane.shape
    return plane.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)


def encode_coefficients(rgb: np.ndarray, quality: int
                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The quantized coefficients libjpeg-turbo writes for
    ``cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
    [cv2.IMWRITE_JPEG_QUALITY, quality])``: Y, Cb and Cr as (bh, bw, 64)
    int64 arrays in natural order over their MCU-padded block grids (Y
    sampled 2 x 2, Cb and Cr 1 x 1), and the (64,) luminance, chrominance,
    chrominance tables. The Huffman stage is lossless, so these decide
    every decoded sample.

    libjpeg-turbo's stages, vectorised over every block:

    * ``jccolor.c``'s fixed-point RGB -> YCbCr;
    * ``jcprepct.c`` / ``jcsample.c``: at full resolution the last row
      replicated to an even height and the last column to the chroma
      blocks' width x 2; ``h2v2_downsample`` (the sum of 2 x 2 samples plus
      a bias alternating 1, 2 along a row, >> 2); the last downsampled row
      (Y: the last row) replicated to the component's block rows; Y's last
      column out to its blocks' width;
    * ``jpeg_fdct_islow`` and ``quantize``;
    * ``jccoefct.c``'s dummy blocks in the MCUs past Y's last block column
      or row: AC 0, the DC of the block before it in the MCU.
    """
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_coefficients takes an (H, W, 3) uint8 RGB "
                         f"image, got {rgb.dtype} {rgb.shape}")
    height, width = rgb.shape[:2]
    mcus_y, mcus_x = -(-height // 16), -(-width // 16)
    hb, wb = -(-height // 8), -(-width // 8)     # Y's real block grid
    r, g, b = (rgb[..., i] for i in range(3))
    y, cb, cr = (((t[0][r] + t[1][g] + t[2][b]) >> 16) for t in _RGB_YCC)
    luma, chroma = quant_tables(quality)

    planes = [_edge_pad(y, 16 * mcus_y, 8 * wb)]
    bias = np.tile([1, 2], 4 * mcus_x)
    for c in (cb, cr):
        full = _edge_pad(c, 2 * (-(-height // 2)), 16 * mcus_x)
        down = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
                + full[1::2, 1::2] + bias) >> 2
        planes.append(_edge_pad(down, 8 * mcus_y, 8 * mcus_x))

    coefs = [quantize(fdct_islow(_blocks(p)), t)
             for p, t in zip(planes, (luma, chroma, chroma))]
    y_coef = np.zeros((2 * mcus_y, 2 * mcus_x, 64), np.int64)
    y_coef[:hb, :wb] = coefs[0][:hb]
    if wb % 2:                                   # dummy column, real rows
        y_coef[:hb, wb, 0] = y_coef[:hb, wb - 1, 0]
    if hb % 2:                                   # dummy row of each MCU
        y_coef[hb, :, 0] = np.repeat(y_coef[hb - 1, 1::2, 0], 2)
    coefs[0] = y_coef
    return coefs, [luma, chroma, chroma]


def jpeg_roundtrip_u8(rgb: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.cvtColor(cv2.imdecode(cv2.imencode(".jpg", cv2.cvtColor(rgb,
    cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, quality])[1],
    cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``, byte for byte: an (H, W, 3)
    uint8 RGB image through libjpeg-turbo's baseline 4:2:0 encoding at
    ``quality`` and back. The coefficients of
    :func:`encode_coefficients` go straight to the decoder's output stage
    (:func:`samples_to_rgb`); the lossless Huffman stage is skipped."""
    coefs, quants = encode_coefficients(rgb, quality)
    return samples_to_rgb(coefs, quants, [(2, 2), (1, 1), (1, 1)],
                          rgb.shape[0], rgb.shape[1])
