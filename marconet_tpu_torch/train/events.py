"""TensorBoard event files without TensorBoard, tensorboardX or protobuf.

The counterpart of tensorboardX's ``SummaryWriter`` as the training loop
uses it (the card's machine has neither package): :class:`EventWriter`
writes ``events.out.tfevents.<time>.<host>`` in TensorBoard's format,

* TFRecord framing: each record is its length (uint64, little-endian),
  the masked CRC-32C of those 8 bytes, the data, and the data's masked
  CRC-32C;
* each record one ``tensorflow.Event`` protobuf message, encoded here by
  hand (varints and length-delimited fields); the first one carries the
  ``file_version`` ``brain.Event:2``;
* scalars as ``Summary.Value.simple_value``, images as
  ``Summary.Image`` holding a PNG (``utils/png.py``), text as a
  ``DT_STRING`` tensor with the text plugin's metadata, as
  ``tf.summary.text`` writes it.

:func:`read_events` reads such a file back, checking the framing and both
CRCs of every record, and decodes the fields the writer writes.

CRC-32C (Castagnoli) is computed with numpy: the data is cut into equal
chunks whose CRC registers advance together, and the chunk CRCs are
combined pairwise with the GF(2) operator that advances a register over
a run of zero bytes, so a multi-megabyte image needs no byte-by-byte
Python loop.
"""

from __future__ import annotations

import functools
import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

from marconet_tpu_torch.utils.png import encode_png

_POLY = 0x82F63B78          # CRC-32C, reflected
_MASK_DELTA = 0xA282EAD8
_CHUNK = 256                # bytes a chunk register walks, vectorized


def _table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t.astype(np.uint32)


_TABLE = _table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _apply(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of 32-bit registers, given by the images of the
    32 unit registers (``op[i]`` = map(1 << i)), applied to ``v``."""
    out = np.zeros_like(v)
    for i in range(32):
        out ^= np.where((v >> np.uint32(i)) & np.uint32(1), op[i],
                        np.uint32(0))
    return out


@functools.lru_cache(maxsize=None)
def _zeros_op_pow2(k: int) -> np.ndarray:
    """The operator advancing a register over 2**k zero bytes."""
    if k == 0:
        unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
        return _TABLE[unit & np.uint32(0xFF)] ^ (unit >> np.uint32(8))
    half = _zeros_op_pow2(k - 1)
    return _apply(half, half)


def _zeros_op(nbytes: int) -> np.ndarray:
    """The operator advancing a register over ``nbytes`` zero bytes."""
    result = np.uint32(1) << np.arange(32, dtype=np.uint32)    # identity
    k = 0
    while nbytes:
        if nbytes & 1:
            result = _apply(_zeros_op_pow2(k), result)
        nbytes >>= 1
        k += 1
    return result


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    n = len(data)
    if n < 4 * _CHUNK:
        reg = 0xFFFFFFFF
        for b in data:
            reg = _TABLE_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
        return reg ^ 0xFFFFFFFF
    # register from 0 over each chunk; zero bytes in front of data leave a
    # register at 0 unchanged, so the data is padded at the front
    m = -(-n // _CHUNK)
    buf = np.zeros(m * _CHUNK, np.uint8)
    buf[m * _CHUNK - n:] = np.frombuffer(data, np.uint8)
    rows = buf.reshape(m, _CHUNK)
    reg = np.zeros(m, np.uint32)
    for j in range(_CHUNK):
        reg = _TABLE[(reg ^ rows[:, j]) & np.uint32(0xFF)] \
            ^ (reg >> np.uint32(8))
    k = _CHUNK.bit_length() - 1         # chunks of 2**k bytes
    while len(reg) > 1:                 # combine neighbours pairwise
        if len(reg) % 2:                # a zero chunk in front adds nothing
            reg = np.concatenate([np.zeros(1, np.uint32), reg])
        reg = _apply(_zeros_op_pow2(k), reg[0::2]) ^ reg[1::2]
        k += 1
    start = _apply(_zeros_op(n), np.array([0xFFFFFFFF], np.uint32))[0]
    return int(reg[0] ^ start) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# -- protobuf wire format ---------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _double(1, wall_time) + _int(2, step) + body


def _summary(tag: str, value: bytes) -> bytes:
    """Event.summary (5) holding one Summary.Value (1) with ``tag``."""
    return _bytes(5, _bytes(1, _bytes(1, tag.encode()) + value))


DT_STRING = 7


class EventWriter:
    """Write TensorBoard scalars, images and text to ``logdir``
    (``add_scalar`` / ``add_image`` / ``add_text`` as tensorboardX's
    ``SummaryWriter`` takes them; images HWC uint8 RGB)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        base = os.path.join(logdir, f"events.out.tfevents.{int(time.time())}"
                            f".{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):
            n += 1
            path = f"{base}.{n}"
        self.path = path
        self._file = open(path, "wb")
        self._write(_event(time.time(), 0, _bytes(3, b"brain.Event:2")))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._file.write(header + struct.pack("<I", masked_crc32c(header))
                         + event + struct.pack("<I", masked_crc32c(event)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step,
                           _summary(tag, _float(2, float(value)))))

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        h, w = img.shape[:2]
        image = (_int(1, h) + _int(2, w) + _int(3, 3)
                 + _bytes(4, encode_png(img)))
        self._write(_event(time.time(), step, _summary(tag, _bytes(4, image))))

    def add_text(self, tag: str, text: str, step: int) -> None:
        metadata = _bytes(1, _bytes(1, b"text"))     # plugin_data.plugin_name
        shape = _bytes(2, _int(1, 1))                # one dim of size 1
        tensor = (_int(1, DT_STRING) + _bytes(2, shape)
                  + _bytes(8, text.encode()))
        self._write(_event(time.time(), step,
                           _summary(tag, _bytes(9, metadata)
                                    + _bytes(8, tensor))))

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- reading back -----------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7


def _fields(buf: bytes) -> List[Tuple[int, object]]:
    """(field number, value) of each field of a message: ints for varints,
    bytes for length-delimited fields, floats for 32 / 64-bit fields."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, = struct.unpack_from("<d", buf, i)
            i += 8
        elif wire == 5:
            value, = struct.unpack_from("<f", buf, i)
            i += 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} not supported")
        out.append((field, value))
    return out


def read_records(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file; raises ``ValueError`` on a bad
    length, a bad CRC or a truncated record."""
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        if len(data) - i < 12:
            raise ValueError(f"{path}: truncated record header at {i}")
        header = data[i:i + 8]
        n, = struct.unpack("<Q", header)
        crc, = struct.unpack_from("<I", data, i + 8)
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at {i}")
        if len(data) - i - 12 < n + 4:
            raise ValueError(f"{path}: truncated record at {i}")
        body = data[i + 12:i + 12 + n]
        crc, = struct.unpack_from("<I", data, i + 12 + n)
        if crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad data CRC at {i}")
        yield body
        i += 16 + n


def read_events(path: str) -> List[Dict]:
    """Decode the events of ``path``: dicts with ``wall_time``, ``step``
    and either ``file_version`` or ``values``, a list of (tag, kind,
    payload) with kind ``scalar`` (float), ``image`` (PNG bytes, with
    height and width) or ``text`` (str)."""
    events = []
    for record in read_records(path):
        event: Dict = {"step": 0, "values": []}
        for field, value in _fields(record):
            if field == 1:
                event["wall_time"] = value
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for _, raw in _fields(value):
                    event["values"].append(_decode_value(raw))
        events.append(event)
    return events


def _decode_value(raw: bytes) -> Tuple[str, str, object]:
    tag, kind, payload = "", None, None
    for field, value in _fields(raw):
        if field == 1:
            tag = value.decode()
        elif field == 2:
            kind, payload = "scalar", value
        elif field == 4:
            image = dict(_fields(value))
            kind, payload = "image", (image[4], image[1], image[2])
        elif field == 8:
            strings = [v for f, v in _fields(value) if f == 8]
            kind, payload = "text", strings[0].decode()
    return tag, kind, payload


def event_files(logdir: str) -> List[str]:
    """The event files under ``logdir``, oldest name first."""
    found: List[str] = []
    for root, _, files in os.walk(logdir):
        found += [os.path.join(root, f) for f in files if "tfevents" in f]
    return sorted(found)


def scalars(logdir: str, tag: str) -> List[Tuple[int, float]]:
    """(step, value) of every ``tag`` scalar in the event files of
    ``logdir``, in file and write order."""
    out: List[Tuple[int, float]] = []
    for path in event_files(logdir):
        for event in read_events(path):
            out += [(event["step"], v) for t, kind, v in event["values"]
                    if t == tag and kind == "scalar"]
    return out

