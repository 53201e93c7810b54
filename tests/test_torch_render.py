"""The port's glyph rendering (``marconet_tpu_torch/utils/raster.py`` and
``text_draw.py``) and what draws with it -- ``TextLineSynthesizer.render``
and ``sample``, ``render_text_row`` and the visual grids, the
``syndata_demo`` CLI -- against PIL and the JAX package, on the fixture
font ``tests/data/fonts/DejaVuSans.ttf``.

PIL's rules are pinned exactly with PIL's own glyph masks: the 8-bit
blend and the clipping, glyph origins rounded to whole pixels (half up),
the glyphs of a string composited with that same blend (not by their
maximum), the baseline at the rounded-up ascender.

The port hints glyphs as PIL's FreeType does (``utils/ttinterp.py``, held
to FreeType point for point in ``tests/test_torch_hinting.py``) and
rasterizes them as FreeType does, so pixels are held equal:

* ``draw_text`` against ``ImageDraw.text`` at sizes 90, 115 and 140 and at
  the render's extreme positions, on ``L`` and ``RGB`` canvases: equal;
* ``render`` against the JAX package's over 200 seeds on one background:
  the same None-or-not and generator state, text, labels, ``char_locs``,
  ink mask and image on every seed;
* ``sample`` on two seeds: ``text``, ``label``, ``boxinfo``, ``gt`` and
  ``mask`` equal; ``lq`` within the degradations' tolerance
  (``tests/test_torch_degrade.py``: its resize and filter follow
  OpenCV's float order, not its bits);
* ``render_text_row``, the visual grid's text row and ``syndata_demo``'s
  files equal the JAX package's (``lq`` within one level);
* the port's render at most 4x PIL's time on 40 seeds.

``python -m tests.torch_render_report`` measures the render over 1000
seeds, both times, and sweeps every glyph against FreeType.
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
from tests.test_torch_degrade import _assert_close
from tests.torch_render_report import compare_renders, summary, \
    time_renders

REPO = pathlib.Path(__file__).resolve().parent.parent
FONT_DIR = str(REPO / "tests" / "data" / "fonts")
FONT = os.path.join(FONT_DIR, "DejaVuSans.ttf")
SIZES = (90, 115, 140)
# the corners of the render's positions: x in [-10, 20], y in [-20, 10]
CORNERS = ((-10, -20), (20, 10), (-10, 10), (20, -20))


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
    inked = 0
    for xy in CORNERS:
        for text in _texts(size, 12):
            want = Image.new("L", (2048, 128))
            ImageDraw.Draw(want).text(xy, text, font=pil, fill=255)
            got = np.zeros((128, 2048), np.uint8)
            text_draw.draw_text(got, xy, text, font, 255)
            np.testing.assert_array_equal(got, np.asarray(want), (xy, text))
            inked += got.any()
    assert inked == len(CORNERS) * (11 + 12)


def test_draw_text_on_rgb_matches_pil():
    pil = ImageFont.truetype(FONT, 115)
    font = text_draw.truetype(FONT, 115)
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 256, (128, 2048, 3), np.uint8)
    img = Image.fromarray(bg.copy())
    ImageDraw.Draw(img).text((7, -5), "Ab中文fi", font=pil, fill=(9, 200, 77))
    got = bg.copy()
    text_draw.draw_text(got, (7, -5), "Ab中文fi", font, (9, 200, 77))
    np.testing.assert_array_equal(got, np.asarray(img))
    assert (got != bg).any(axis=2).sum() > 1000


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
    assert c["texts"] and c["agree"] == c["seeds"] and c["drawn"] > 150
    assert (c["locs"] == 0).all()
    assert c["masks"] == c["images"] == c["drawn"]


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_matches_jax(synths, seed):
    jax_synth, port_synth = synths
    want = jax_synth.sample(np.random.default_rng(seed))
    got = port_synth.sample(np.random.default_rng(seed))
    assert got["text"] == want["text"]
    for key in ("label", "boxinfo", "gt", "mask"):
        np.testing.assert_array_equal(got[key], want[key], key)
    _assert_close(got["lq"], want["lq"], "lq")


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
    assert (got[..., [0, 2]] == 0).all() and got.any()
    np.testing.assert_array_equal(got, want)


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
    np.testing.assert_array_equal(grids["1_pred_text"], want["1_pred_text"])


def test_syndata_demo_matches_jax_tool(tmp_path, capsys):
    """The same files and the same printed lines: every sample's text,
    its ``gt``, ``mask`` and ``locs`` images equal, its ``lq`` within one
    level (the degradations' tolerance)."""
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
    assert got_lines[:3] == want_lines[:3]
    assert got_lines[-1].split(" to ")[0] == want_lines[-1].split(" to ")[0]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 12
    import cv2
    for name in names:
        want = cv2.cvtColor(cv2.imread(str(jax_dir / name)),
                            cv2.COLOR_BGR2RGB)
        got = read_png(str(port_dir / name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name.endswith("_lq.png"):
            _assert_close(got / 255.0, want / 255.0, name)
        else:
            np.testing.assert_array_equal(got, want, name)
