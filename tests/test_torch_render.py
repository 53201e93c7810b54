"""The port's glyph rendering (``marconet_tpu_torch/utils/raster.py`` and
``text_draw.py``) and what draws with it -- ``TextLineSynthesizer.render``
and ``sample``, ``render_text_row`` and the visual grids, the
``syndata_demo`` CLI -- against PIL and the JAX package, on the fixture
font ``tests/data/fonts/DejaVuSans.ttf``.

PIL's rules are pinned exactly with PIL's own glyph masks: the 8-bit
blend and the clipping, glyph origins rounded to whole pixels (half up),
the glyphs of a string composited with that same blend (not by their
maximum), the baseline at the rounded-up ascender.

The port draws unhinted outlines where PIL runs the font's TrueType
hinting, so pixels are held to tolerances, chosen from what hinting moves
(stems by up to a pixel, vertically) and measured over 1000 seeds
(``PERF.md``):

* ``draw_text`` against ``ImageDraw.text`` at sizes 90, 115 and 140 and at
  the render's extreme positions: first and last ink columns within 2 px;
  IoU of the ``> 128`` masks at least 0.8 on every case and 0.9 on
  average;
* ``render`` against the JAX package's over 200 seeds on one background:
  the same text and labels; the same None-or-not and generator state
  after it on at least 98% of seeds; ``char_locs`` within 2 px on at
  least 99% of the rendered seeds (a hinted stem snaps across the canvas
  edge on some seeds: 1 of 200 here, 4 of 1000) and within 8 px on all;
  mask IoU as above;
* ``sample`` on two seeds: ``label``, ``text`` and ``boxinfo`` within
  2/2048;
* the port's render at most 4x PIL's time on 40 seeds.

``python -m tests.torch_render_report`` measures the render's rates over
1000 seeds and both times.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from marconet_tpu.data import synth as jsynth
from marconet_tpu.train import visuals as jvisuals
from marconet_tpu_torch.alphabet import alphabet
from marconet_tpu_torch.cli import syndata_demo
from marconet_tpu_torch.data import synth as tsynth
from marconet_tpu_torch.train import visuals as tvisuals
from marconet_tpu_torch.utils import raster, text_draw
from marconet_tpu_torch.utils.png import read_png
from tests.torch_render_report import compare_renders, summary, \
    time_renders

REPO = pathlib.Path(__file__).resolve().parent.parent
FONT_DIR = str(REPO / "tests" / "data" / "fonts")
FONT = os.path.join(FONT_DIR, "DejaVuSans.ttf")
SIZES = (90, 115, 140)
# the corners of the render's positions: x in [-10, 20], y in [-20, 10]
CORNERS = ((-10, -20), (20, 10), (-10, 10), (20, -20))
COLUMNS_PX = 2
IOU_EACH, IOU_MEAN = 0.8, 0.9


def _pil_mask(font, text):
    core, offset = font.getmask2(text, mode="L", anchor="la")
    return np.asarray(Image.Image()._new(core)), offset


def _texts(seed: int, n: int):
    chars = alphabet()
    rng = np.random.default_rng(seed)
    fixed = ["Hello", "office", "AVATAR", "fijl", "Wg@%", "éüúàǎ",
             "βδαΙиОфРП", "⑧⒀①Ⅳ√", "ㄖぴな", "中文ab12", "Ｑ（）｛"]
    return fixed + ["".join(chars[i] for i in rng.integers(0, len(chars), k))
                    for k in rng.integers(4, 17, n)]


def _ink(img):
    cols = np.nonzero(img.astype(np.int64).sum(axis=0) > 1)[0]
    return (int(cols.min()), int(cols.max())) if cols.size else None


def _iou(a, b):
    union = (a | b).sum()
    return (a & b).sum() / union if union else 1.0


# -- PIL's rules, pinned -----------------------------------------------------


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_blend_and_clipping_match_pil(mode):
    """PIL's own mask through ``blend`` gives PIL's canvas exactly, on a
    random canvas, a part of the text off each edge."""
    rng = np.random.default_rng(1)
    font = ImageFont.truetype(FONT, 115)
    shape = (128, 400) if mode == "L" else (128, 400, 3)
    for xy, text in (((-10, -20), "fgjA中"), ((330, 40), "WVQy"),
                     ((20, 10), "ｊ✓")):
        canvas = rng.integers(0, 256, shape, np.uint8)
        ink = 255 if mode == "L" else tuple(int(v) for v in
                                            rng.integers(0, 256, 3))
        img = Image.fromarray(canvas.copy())
        ImageDraw.Draw(img).text(xy, text, font=font, fill=ink)
        mask, (dx, dy) = _pil_mask(font, text)
        got = canvas.copy()
        text_draw.blend(got, mask, (xy[0] + dx, xy[1] + dy), ink)
        np.testing.assert_array_equal(got, np.asarray(img))


def _pil_img(font, text):
    img = Image.new("L", (1200, 160))
    ImageDraw.Draw(img).text((0, 0), text, font=font, fill=255)
    return np.asarray(img)


def test_glyph_origins_round_to_whole_pixels():
    """A glyph after a prefix whose advance is fractional is PIL's same
    bitmap moved by the pen position rounded half up: no sub-pixel
    phase, so bitmaps are cached by (face, size, glyph)."""
    halves = 0
    for size in (90, 101, 117, 128):
        pil = ImageFont.truetype(FONT, size)
        face = text_draw.truetype(FONT, size).face
        alone, (lx, ly) = _pil_mask(pil, "l")
        for k in range(1, 9):
            prefix = "." * k
            pen = face.shape(prefix + "l", size)[1][-1]
            assert pen == round(pil.getlength(prefix) * 64)
            halves += pen % 64 == 32
            x = ((pen + 32) >> 6) + lx
            assert x > _ink(_pil_img(pil, prefix))[1] + 1
            got = _pil_img(pil, prefix + "l")
            np.testing.assert_array_equal(
                got[ly:ly + alone.shape[0], x:x + alone.shape[1]], alone)
            assert not got[:, x + alone.shape[1]:].any()
    assert halves >= 1                  # the half-pixel case is covered


def test_glyphs_composite_like_the_blend():
    """Where two glyphs' bitmaps overlap, PIL's string mask is the second
    blended over the first with ink 255 (``a + b - a * b / 255`` in 8
    bits), each glyph placed at its rounded pen; their maximum, which
    would differ there, is not it."""
    overlapping = 0
    for size in SIZES:
        pil = ImageFont.truetype(FONT, size)
        face = text_draw.truetype(FONT, size).face
        for text in ("YV", "TT", "__", "KA", "fT", "AV", "Ty"):
            glyphs, xs, _ = face.shape(text, size)
            assert len(glyphs) == 2
            canvas = np.zeros((400, 800), np.uint8)
            biggest = np.zeros_like(canvas)
            for ch, x in zip(text, xs):
                m, (dx, dy) = _pil_mask(pil, ch)
                x0, y0 = 100 + ((x + 32) >> 6) + dx, 100 + dy
                text_draw.blend(canvas, m, (x0, y0), 255)
                sl = (slice(y0, y0 + m.shape[0]), slice(x0, x0 + m.shape[1]))
                biggest[sl] = np.maximum(biggest[sl], m)
            img = Image.new("L", (800, 400))
            ImageDraw.Draw(img).text((100, 100), text, font=pil, fill=255)
            np.testing.assert_array_equal(np.asarray(img), canvas, text)
            overlapping += (biggest != canvas).any()
    assert overlapping >= 4


def test_baseline_is_the_rounded_up_ascender():
    """'x' sits on the baseline: its last ink row is the row above
    ``ascender`` (FreeType's size ascender rounded up), in PIL's draw and
    the port's, at every size the synthesizer draws."""
    for size in range(90, 141):
        font = text_draw.truetype(FONT, size)
        ascent = font.getmetrics()[0]
        rows = np.nonzero(_pil_img(ImageFont.truetype(FONT, size),
                                   "x").sum(axis=1))[0]
        assert rows.max() + 1 == ascent, size
        canvas = np.zeros((160, 200), np.uint8)
        text_draw.draw_text(canvas, (0, 0), "x", font, 255)
        assert np.nonzero(canvas.sum(axis=1))[0].max() + 1 == ascent, size


def test_fill_gives_exact_area_coverage():
    """``raster.fill`` on polygons whose pixel areas are known: a square
    from (0.5, 0.5) to (3.5, 3.5) with a hole from (1.5, 1.5) to (2.5,
    2.5) wound the other way, and a right triangle over a 2 x 2 block;
    coverage is the area times 256, capped at 255."""
    def poly(*pts):
        return np.array([(*pts[i], *pts[(i + 1) % len(pts)])
                         for i in range(len(pts))], np.float64)

    square = poly((0.5, 0.5), (3.5, 0.5), (3.5, 3.5), (0.5, 3.5))
    hole = poly((1.5, 1.5), (1.5, 2.5), (2.5, 2.5), (2.5, 1.5))
    got = raster.fill(np.concatenate([square, hole]), 4, 4)
    area = np.array([[.25, .5, .5, .25], [.5, 1, 1, .5],
                     [.5, 1, 1, .5], [.25, .5, .5, .25]])
    area[1:3, 1:3] -= 0.25
    np.testing.assert_array_equal(got, np.minimum(area * 256, 255))
    tri = raster.fill(poly((0, 0), (2, 2), (0, 2)), 2, 2)
    np.testing.assert_array_equal(tri, [[128, 0], [255, 128]])


# -- drawing against PIL -----------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_draw_text_matches_pil(size):
    pil = ImageFont.truetype(FONT, size)
    font = text_draw.truetype(FONT, size)
    ious, cols = [], 0
    for xy in CORNERS:
        for text in _texts(size, 12):
            want = Image.new("L", (2048, 128))
            ImageDraw.Draw(want).text(xy, text, font=pil, fill=255)
            want = np.asarray(want)
            got = np.zeros((128, 2048), np.uint8)
            text_draw.draw_text(got, xy, text, font, 255)
            a, b = _ink(want), _ink(got)
            assert (a is None) == (b is None), (xy, text)
            if a is not None:
                cols = max(cols, abs(a[0] - b[0]), abs(a[1] - b[1]))
                assert cols <= COLUMNS_PX, (xy, text, a, b)
            iou = _iou(want > 128, got > 128)
            assert iou >= IOU_EACH, (xy, text, iou)
            ious.append(iou)
    print(f"size {size}: {len(ious)} draws, ink columns within {cols} px, "
          f"IoU min {min(ious):.4f} mean {np.mean(ious):.4f}")
    assert np.mean(ious) >= IOU_MEAN


def test_draw_text_on_rgb_matches_pil():
    pil = ImageFont.truetype(FONT, 115)
    font = text_draw.truetype(FONT, 115)
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 256, (128, 2048, 3), np.uint8)
    img = Image.fromarray(bg.copy())
    ImageDraw.Draw(img).text((7, -5), "Ab中文fi", font=pil, fill=(9, 200, 77))
    got = bg.copy()
    text_draw.draw_text(got, (7, -5), "Ab中文fi", font, (9, 200, 77))
    want = np.asarray(img)
    changed_w, changed_g = (want != bg).any(axis=2), (got != bg).any(axis=2)
    assert _iou(changed_w, changed_g) >= IOU_EACH
    # where the port's mask is full, the pixel is the fill colour
    mask, (dx, dy) = font.getmask("Ab中文fi")
    marks = np.zeros((128, 2048), np.uint8)
    text_draw.blend(marks, mask, (7 + dx, -5 + dy), 255)
    full = marks == 255
    assert full.sum() > 1000 and (got[full] == [9, 200, 77]).all()


# -- the synthesizer against the JAX package ---------------------------------


@pytest.fixture(scope="module")
def synths():
    return (jsynth.TextLineSynthesizer(jsynth.SynthConfig(font_dir=FONT_DIR)),
            tsynth.TextLineSynthesizer(tsynth.SynthConfig(font_dir=FONT_DIR)))


def test_font_paths_match_jax(synths, tmp_path):
    jax_synth, port_synth = synths
    assert port_synth.font_paths == jax_synth.font_paths == [FONT]
    for d in (str(tmp_path), str(tmp_path / "missing")):
        assert tsynth.TextLineSynthesizer(tsynth.SynthConfig(
            font_dir=d)).font_paths == jsynth.TextLineSynthesizer(
                jsynth.SynthConfig(font_dir=d)).font_paths


def test_render_matches_jax():
    c = compare_renders(200)
    print(summary(c))
    assert c["texts"]
    assert c["agree"] >= 0.98 * c["seeds"]
    assert (c["locs"] <= COLUMNS_PX).mean() >= 0.99 and c["locs"].max() <= 8
    assert c["iou"].min() >= IOU_EACH and c["iou"].mean() >= IOU_MEAN


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_matches_jax(synths, seed):
    jax_synth, port_synth = synths
    want = jax_synth.sample(np.random.default_rng(seed))
    got = port_synth.sample(np.random.default_rng(seed))
    assert got["text"] == want["text"]
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["boxinfo"], want["boxinfo"], rtol=0,
                               atol=2 / 2048)
    for key in ("gt", "mask", "lq"):
        assert got[key].shape == want[key].shape, key


def test_render_time_within_four_times_pil():
    t = time_renders(40)
    print(f"render: PIL {t['pil_ms']:.2f} ms, port {t['port_ms']:.2f} ms "
          f"a line")
    assert t["ratio"] <= 4.0


# -- the other drawers -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_render_text_row_matches_jax(seed):
    ids = np.random.default_rng(seed).integers(0, len(alphabet()) + 1, 30)
    text = jvisuals.ctc_collapse_ids(ids) + "fi12"
    want = jvisuals.render_text_row(text, font_path=FONT)
    got = tvisuals.render_text_row(text, FONT)
    assert got.shape == want.shape == (32, 512, 3) and got.dtype == np.uint8
    assert (got[..., [0, 2]] == 0).all()
    a, b = _ink(want[..., 1]), _ink(got[..., 1])
    assert abs(a[0] - b[0]) <= COLUMNS_PX and abs(a[1] - b[1]) <= COLUMNS_PX
    assert _iou(want[..., 1] > 128, got[..., 1] > 128) >= IOU_EACH


def test_visual_grid_draws_the_text_with_a_font():
    rng = np.random.default_rng(5)
    b, n = 2, 4

    def img(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    arrays = dict(gt=img(b, 128, 128 * n, 3), lq=img(b, 32, 32 * n, 3),
                  sr=img(b, 128, 128 * n, 3),
                  prior128=img(b, n, 128, 128, 3),
                  gt_chars=img(b, n, 128, 128, 3),
                  pred_cw=rng.uniform(0, 0.2, (b, 2 * n)).astype(np.float32),
                  boxinfo_lr=np.sort(rng.uniform(0, 1, (b, 2 * n)),
                                     axis=1).astype(np.float32),
                  pred_ids=rng.integers(0, 100, (b, 2 * n)))
    want = jvisuals.build_visual_grids(**arrays, font_path=FONT)
    grids, text = tvisuals.build_visual_grids(**arrays, font_path=FONT)
    assert set(grids) == set(want)
    np.testing.assert_array_equal(
        grids["1_pred_text"], tvisuals.render_text_row(text, FONT))
    assert _iou(grids["1_pred_text"][..., 1] > 128,
                want["1_pred_text"][..., 1] > 128) >= IOU_EACH


def test_syndata_demo_matches_jax_tool(tmp_path, capsys):
    """The same files of the same shapes and the same printed lines. The
    first sample's text is the same on both sides; a later one's only
    while the generators agree, and the Poisson noise of the degradations
    draws as many variates as the pixels ask for, so one differing pixel
    parts the streams: later texts are compared in number, not value."""
    args = ["-o", None, "-n", "3", "--font_dir", FONT_DIR,
            "--bg_dir", str(tmp_path / "none")]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    args[1] = str(jax_dir)
    proc = subprocess.run([sys.executable, str(REPO / "tools" /
                                               "syndata_demo.py")] + args,
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    args[1] = str(port_dir)
    syndata_demo.main(args)
    want_lines = proc.stdout.splitlines()
    got_lines = capsys.readouterr().out.splitlines()
    assert len(got_lines) == len(want_lines) == 4
    assert got_lines[0] == want_lines[0]
    assert got_lines[-1].split(" to ")[0] == want_lines[-1].split(" to ")[0]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 12
    import cv2
    for name in names:
        want = cv2.cvtColor(cv2.imread(str(jax_dir / name)),
                            cv2.COLOR_BGR2RGB)
        got = read_png(str(port_dir / name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
    want = cv2.imread(str(jax_dir / "000_mask.png"))[..., 0] > 0
    assert _iou(read_png(str(port_dir / "000_mask.png"))[..., 0] > 0,
                want) >= IOU_EACH
