"""The port's JPEG decoder (``marconet_tpu_torch.utils.jpeg``) and
``utils/imread.py`` against cv2.

``read_jpeg`` must return what the JAX package gets from
``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``,
byte for byte (tolerance: none). Files come from cv2's and PIL's encoders
(both libjpeg-turbo) on seeded images: qualities 50, 75 and 95, sampling
4:4:4, 4:2:2, 4:2:0 and 4:4:0, baseline and progressive, restart
intervals, optimised Huffman tables, grayscale, sizes from 1 x 1 to
400 x 400, and EXIF orientations 1-8. Unsupported variants (made by
patching a marker of a good file) raise a ``ValueError`` naming the file.

The fixtures under ``tests/data/jpeg/`` (the files the card's smoke run
decodes and times, where there is no cv2) are held to ``cv2.imread``
here, so a stale fixture fails. ``python -m tests.test_torch_jpeg``
writes them anew.
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from marconet_tpu_torch.utils import imread as imread_mod
from marconet_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg
from marconet_tpu_torch.utils.png import read_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
SIZES = [(1, 1), (7, 13), (37, 101), (33, 517), (400, 400)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _image(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients under seeded noise: every coefficient band is busy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(3 * x + y) % 256, (5 * y) % 256, (x * y) % 256], -1)
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255) \
        .astype(np.uint8)


def _check(data: bytes) -> None:
    want = _cv2_rgb(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_cv2_encodes(quality, sampling, progressive):
    for i, (h, w) in enumerate(SIZES):
        ok, buf = cv2.imencode(".jpg", _image(h, w, i), [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        assert ok
        _check(buf.tobytes())


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])    # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_encodes(quality, subsampling, progressive):
    """PIL's encoder, optimised Huffman tables included."""
    for i, (h, w) in enumerate([(37, 101), (8, 8), (33, 517)]):
        b = io.BytesIO()
        Image.fromarray(_image(h, w, 10 + i)).save(
            b, "JPEG", quality=quality, subsampling=subsampling,
            progressive=progressive, optimize=bool(i % 2))
        _check(b.getvalue())


@pytest.mark.parametrize("case", ["rst1", "rst3_progressive", "rst7_420",
                                  "optimize", "gray", "gray_progressive"])
def test_options(case):
    """Restart intervals (baseline and progressive), optimised tables and
    one-component files (gray replicated into three channels)."""
    img = _image(37, 101, 20)
    params = {"rst1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
              "rst3_progressive": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                                   cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "rst7_420": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING["420"]],
              "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
              "gray": [], "gray_progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                               1]}[case]
    if case.startswith("gray"):
        img = img[..., 0]
    ok, buf = cv2.imencode(".jpg", img, params)
    _check(buf.tobytes())


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    """cv2 turns and flips by the EXIF orientation; so does the port."""
    b = io.BytesIO()
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(_image(37, 101, orientation)).save(
        b, "JPEG", quality=90, exif=exif.tobytes())
    path = tmp_path / "o.jpg"
    path.write_bytes(b.getvalue())
    want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    assert want.shape[:2] == ((101, 37) if orientation > 4 else (37, 101))
    np.testing.assert_array_equal(read_jpeg(str(path)), want)


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` after ``marker`` set to value."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1:]


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12bit", "cmyk",
                                  "411", "incomplete", "truncated"])
def test_unsupported_raise_naming_the_file(tmp_path, case):
    img = _image(16, 32, 30)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1] \
        .tobytes()
    if case == "arithmetic":
        data, why = _patched(base, b"\xff\xc0", 1, 0xC9), "arithmetic"
    elif case == "lossless":
        data, why = _patched(base, b"\xff\xc0", 1, 0xC3), "lossless"
    elif case == "12bit":
        data, why = _patched(base, b"\xff\xc0", 4, 12), "12-bit"
    elif case == "cmyk":
        b = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(b, "JPEG")
        data, why = b.getvalue(), "CMYK"
    elif case == "411":              # Y sampled 4 x 1
        data, why = _patched(base, b"\xff\xc0", 11, 0x41), "4:1:1"
    elif case == "incomplete":       # the progressive scans cut short
        cut = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
        data, why = prog[:cut] + b"\xff\xd9", "incomplete"
    else:
        data, why = base[:len(base) // 2], "truncated"
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError) as err:
        read_jpeg(str(path))
    assert str(path) in str(err.value) and why in str(err.value), \
        str(err.value)


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def _line(h: int, w: int, seed: int) -> np.ndarray:
    """A text-like line: strokes on a flat paper colour (flat blocks keep
    the PNG of its decode small)."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = rng.integers(170, 240, 3)
    x = 4
    while x < w - 8:
        cw = int(rng.integers(h // 3, h))
        col = tuple(int(v) for v in rng.integers(0, 80, 3))
        for _ in range(3):
            p1 = (int(x + rng.integers(0, cw)),
                  int(rng.integers(h // 6, h - h // 6)))
            p2 = (int(x + rng.integers(0, cw)),
                  int(rng.integers(h // 6, h - h // 6)))
            cv2.line(img, p1, p2, col, max(1, h // 16))
        x += cw + int(rng.integers(h // 3, h))
    return img


def _background(n: int, seed: int) -> np.ndarray:
    """Flat rectangles and ellipses of seeded colours."""
    rng = np.random.default_rng(seed)
    img = np.empty((n, n, 3), np.uint8)
    img[:] = rng.integers(60, 200, 3)
    for _ in range(12):
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        if rng.random() < 0.5:
            cv2.rectangle(img, tuple(int(v) for v in rng.integers(0, n, 2)),
                          tuple(int(v) for v in rng.integers(0, n, 2)), c, -1)
        else:
            cv2.ellipse(img, tuple(int(v) for v in rng.integers(0, n, 2)),
                        tuple(int(v) for v in rng.integers(5, n // 4, 2)),
                        float(rng.uniform(0, 180)), 0, 360, c, -1)
    return img


def write_fixtures(d: str = FIXTURES) -> None:
    """The smoke run's three timed JPEGs (a 512 x 32 line at 4:2:0, a
    1400 x 72 progressive line, a 400 x 400 background), one with EXIF
    orientation 6, and cv2's decode of each as ``<name>.png``."""
    os.makedirs(d, exist_ok=True)
    q90 = [cv2.IMWRITE_JPEG_QUALITY, 90]
    specs = {"line_512x32_420.jpg": (_line(32, 512, 1), q90 + [
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]),
             "line_1400x72_progressive.jpg": (_line(72, 1400, 2), q90 + [
                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
             "bg_400x400.jpg": (_background(400, 3), q90)}
    for name, (rgb, params) in specs.items():
        ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], params)
        with open(os.path.join(d, name), "wb") as f:
            f.write(buf.tobytes())
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_line(37, 101, 4)).save(
        os.path.join(d, "exif_orientation6.jpg"), "JPEG", quality=90,
        exif=exif.tobytes())
    for name in list(specs) + ["exif_orientation6.jpg"]:
        if name.endswith(".jpg"):
            path = os.path.join(d, name)
            cv2.imwrite(path[:-4] + ".png", cv2.imread(path),
                        [cv2.IMWRITE_PNG_COMPRESSION, 9])


FIXTURE_NAMES = ["line_512x32_420", "line_1400x72_progressive",
                 "bg_400x400", "exif_orientation6"]


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_is_cv2s_decode(name):
    """The committed decode is cv2's, and the port decodes to it."""
    jpg = os.path.join(FIXTURES, name + ".jpg")
    want = cv2.cvtColor(cv2.imread(jpg), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(jpg[:-4] + ".png"), want)
    np.testing.assert_array_equal(read_jpeg(jpg), want)


def test_fixtures_are_small():
    """The decoder's fixtures (the files beside ``roundtrip/``, whose
    encoder fixtures ``test_torch_jpeg_encode.py`` holds)."""
    names = [n for n in os.listdir(FIXTURES)
             if os.path.isfile(os.path.join(FIXTURES, n))]
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names)
    assert len(names) == 2 * len(FIXTURE_NAMES)
    assert total <= 150_000, total


# ---------------------------------------------------------------------------
# imread: the decoder by magic bytes, None where cv2 gives None
# ---------------------------------------------------------------------------

def _files(tmp_path):
    img = _image(9, 14, 40)
    png = cv2.imencode(".png", img)[1].tobytes()
    files = {
        "photo.png": cv2.imencode(".jpg", img)[1].tobytes(),   # a JPEG
        "scan.jpg": cv2.imencode(".bmp", img)[1].tobytes(),    # a BMP
        "line.bmp": png,                                       # a PNG
        "notes.png": b"not an image\n",
        "empty.jpg": b"",
        "cut.png": png[:len(png) // 2],
        "badcrc.png": png[:40] + bytes([png[40] ^ 1]) + png[41:],
        "sof_only.jpg": b"\xff\xd8\xff\xd9",
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    (tmp_path / "dir.png").mkdir()
    return sorted(files) + ["dir.png", "missing.png"]


def test_imread_dispatches_by_content_and_none_where_cv2_is(tmp_path):
    for name in _files(tmp_path):
        path = str(tmp_path / name)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = imread_mod.imread(path)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(
                got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB), name)


@pytest.mark.parametrize("fmt", [".tiff", ".webp"])
def test_imread_names_formats_it_leaves_out(tmp_path, fmt):
    """cv2 reads TIFF and WebP; the port refuses them by name rather
    than take them for unreadable files."""
    path = tmp_path / f"img{fmt}"
    cv2.imwrite(str(path), _image(8, 8, 50))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(ValueError, match=str(path)):
        imread_mod.imread(str(path))


if __name__ == "__main__":
    write_fixtures()
