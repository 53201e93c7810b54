"""``cv2.imread`` for the port: any image the JAX package reads, without
cv2.

:func:`imread` returns what ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` returns, an (H, W, 3) uint8 RGB
image, and None where ``cv2.imread`` returns None: a missing or
unreadable path, a file whose first bytes name no image format, or a
file of a known format that is corrupt (:class:`~marconet_tpu_torch.
utils.png.CorruptImage`). Like cv2 it picks the decoder by the file's
magic bytes, not by its extension: PNG (``utils/png.py``), JPEG
(``utils/jpeg.py``) and BMP (``utils/bmp.py``). A file of another format
cv2 decodes (TIFF, WebP, GIF, JPEG 2000, PNM, ...), or one of these three
in a variant the port's decoders leave out, raises a ``ValueError`` that
names the file and the reason, so a caller never takes it for an
unreadable one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from marconet_tpu_torch.utils.bmp import decode_bmp
from marconet_tpu_torch.utils.jpeg import decode_jpeg
from marconet_tpu_torch.utils.png import SIGNATURE, CorruptImage, decode_png

# formats cv2 decodes that the port does not, by their first bytes
_OTHER_FORMATS = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"),
                  (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"),
                  (b"\x76\x2f\x31\x01", "OpenEXR"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
                  (b"\x59\xa6\x6a\x95", "Sun raster"))


def _other_format(head: bytes) -> Optional[str]:
    for magic, name in _OTHER_FORMATS:
        if head.startswith(magic):
            return name
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if head[:1] == b"P" and head[1:2] and head[1:2] in b"1234567Ff" \
            and head[2:3].isspace():
        return "PNM / PFM"
    return None


def imread(path: str) -> Optional[np.ndarray]:
    """An (H, W, 3) uint8 RGB image, or None where ``cv2.imread`` gives
    None (see the module docstring)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if data.startswith(SIGNATURE):
            return decode_png(data, str(path))
        if data.startswith(b"\xff\xd8\xff"):
            return decode_jpeg(data, str(path))
        if data.startswith(b"BM"):
            return decode_bmp(data, str(path))
    except CorruptImage:
        return None
    other = _other_format(data[:16])
    if other is not None:
        raise ValueError(f"{path}: {other} images are not supported (PNG, "
                         "JPEG and BMP are)")
    return None
