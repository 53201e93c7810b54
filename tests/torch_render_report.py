"""The port's text-line render (``marconet_tpu_torch/utils/truetype.py``,
``raster.py``, ``text_draw.py`` under ``TextLineSynthesizer.render``)
against the JAX package's (PIL, FreeType, RAQM), on the fixture font
``tests/data/fonts/DejaVuSans.ttf``::

    python -m tests.torch_render_report [--seeds 1000] [--timed 40]
        [--write-digests]

prints, over ``--seeds`` seeds on one flat background, how often both
renders leave the generator in the same state (and agree on
None-or-not), how far ``char_locs`` lie apart, and the IoU of the ink
masks; then the mean host milliseconds a render of each over ``--timed``
seeds, interleaved in one process so both see the same machine, each
side starting with cold caches (its font parsed and its glyphs
rasterized inside the timed renders, as in a fresh data worker).
``tests/test_torch_render.py`` holds 200 seeds and the 40 timed ones to
its tolerances. Then it sweeps the glyphs the model's alphabet reaches
(one character each, ``.notdef`` included) at sizes 32 and 90-140 and
prints the share of (size, glyph) pairs whose hinted points equal
Pillow's FreeType's (``tests/freetype_oracle.py``) and whose bitmaps
equal FreeType's, listing any pair that parts. ``--write-digests``
writes ``tests/data/fonts/DejaVuSans.hinted.json``: the SHA-256 of the
ink of Pillow's ``getmask`` for each of those glyphs at 32, 90, 115 and
140 px: a record of Pillow's glyphs for a host without Pillow, which
``tests/test_torch_hinting.py`` holds to Pillow's masks (the port's glyphs
are held to FreeType's there and in ``tests/test_torch_render.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import time
from typing import Dict, List, Tuple

import numpy as np

FONT_DIR = str(pathlib.Path(__file__).parent / "data" / "fonts")
FONT = str(pathlib.Path(FONT_DIR) / "DejaVuSans.ttf")
SWEEP_SIZES = (32,) + tuple(range(90, 141))
DIGEST_SIZES = (32, 90, 115, 140)
DIGESTS = pathlib.Path(FONT_DIR).parent / "DejaVuSans.hinted.json"


def _synths():
    from marconet_tpu.data import synth as jsynth
    from marconet_tpu_torch.data import synth as tsynth

    jax_synth = jsynth.TextLineSynthesizer(
        jsynth.SynthConfig(font_dir=FONT_DIR))
    port_synth = tsynth.TextLineSynthesizer(
        tsynth.SynthConfig(font_dir=FONT_DIR))
    return jax_synth, port_synth, jax_synth.background(
        np.random.default_rng(0))


def compare_renders(seeds: int) -> Dict:
    """Over seeds ``0 .. seeds - 1``: ``agree`` (seeds whose renders leave
    equal generator states and are both None or both drawn), ``drawn``
    (seeds both drew), ``locs`` (the largest ``char_locs`` distance of
    each seed both drew), ``iou`` (of the ink masks over their common
    width, same seeds), ``masks`` and ``images`` (seeds whose ink mask,
    image equal the JAX package's), ``texts`` (whether text and labels
    were equal on every seed both drew)."""
    jax_synth, port_synth, bg = _synths()
    agree, locs, ious, texts = 0, [], [], True
    masks = images = 0
    for seed in range(seeds):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want, got = jax_synth.render(rj, bg), port_synth.render(rt, bg)
        agree += ((want is None) == (got is None) and
                  rj.bit_generator.state == rt.bit_generator.state)
        if want is None or got is None:
            continue
        texts &= got[2:4] == want[2:4]
        locs.append(int(np.abs(np.subtract(got[4], want[4])).max()))
        w = min(got[1].shape[1], want[1].shape[1])
        a, b = got[1][:, :w, 0] > 0, want[1][:, :w, 0] > 0
        ious.append(float((a & b).sum() / max((a | b).sum(), 1)))
        masks += got[1].shape == want[1].shape and \
            bool((got[1] == want[1]).all())
        images += got[0].shape == want[0].shape and \
            bool((got[0] == want[0]).all())
    return {"seeds": seeds, "agree": agree, "drawn": len(locs),
            "locs": np.array(locs), "iou": np.array(ious), "masks": masks,
            "images": images, "texts": texts}


def time_renders(seeds: int = 40) -> Dict[str, float]:
    """Mean ms a render of the JAX package and of the port over ``seeds``
    seeds (the seed's generator draws the text, size, place and colour;
    one flat background for all), and their ratio."""
    from marconet_tpu_torch.utils.raster import glyph_bitmap
    from marconet_tpu_torch.utils.truetype import load_face

    load_face.cache_clear()
    glyph_bitmap.cache_clear()
    jax_synth, port_synth, bg = _synths()
    totals = {"pil_ms": 0.0, "port_ms": 0.0}
    for seed in range(seeds):
        for key, synth in (("pil_ms", jax_synth), ("port_ms", port_synth)):
            rng = np.random.default_rng(seed)
            t0 = time.perf_counter()
            synth.render(rng, bg)
            totals[key] += time.perf_counter() - t0
    out = {k: v * 1e3 / seeds for k, v in totals.items()}
    out["ratio"] = out["port_ms"] / out["pil_ms"]
    return out


def summary(c: Dict) -> str:
    locs, iou = c["locs"], c["iou"]
    return (f"render over {c['seeds']} seeds: stream agreement "
            f"{c['agree']}/{c['seeds']}; text and labels equal "
            f"{c['texts']}; char_locs equal on {(locs == 0).sum()}, within "
            f"2 px on {(locs <= 2).sum()} of {len(locs)} (max {locs.max()} "
            f"px); mask IoU min {iou.min():.4f} mean {iou.mean():.4f}; "
            f"masks equal on {c['masks']}, images on {c['images']} of "
            f"{c['drawn']}")


def alphabet_glyphs(face) -> List[Tuple[int, str]]:
    """(glyph, character) for each glyph the model's alphabet reaches
    through the character map, by its first character; ``.notdef`` by the
    first character the font lacks."""
    from marconet_tpu_torch.alphabet import alphabet

    first: Dict[int, str] = {}
    for ch in alphabet():
        first.setdefault(face.glyph_index(ch), ch)
    return sorted(first.items())


def sweep(sizes=SWEEP_SIZES) -> Dict:
    """Hinted points and bitmaps of :func:`alphabet_glyphs` at ``sizes``
    against FreeType: the pair count, the exact ones, and the pairs that
    part with the first point that parts (or the bitmap)."""
    from marconet_tpu_torch.utils import raster
    from marconet_tpu_torch.utils.truetype import TrueTypeFace
    from tests.freetype_oracle import Face

    face, oracle = TrueTypeFace(FONT), Face(FONT)
    glyphs = [g for g, _ in alphabet_glyphs(face)]
    pairs, points_ok, bitmaps_ok, parted = 0, 0, 0, []
    for size in sizes:
        for gid in glyphs:
            pairs += 1
            want = oracle.load(gid, size)
            got = face.hinted_outline(gid, size)
            same = (got.points.shape == want.points.shape
                    and (got.points == want.points).all()
                    and (got.on == (want.tags & 1).astype(bool)).all())
            points_ok += same
            if not same:
                rows = np.nonzero((got.points != want.points).any(axis=1))[0] \
                    if got.points.shape == want.points.shape else [-1]
                parted.append((size, gid, f"point {int(rows[0])}"
                               if len(rows) else "tags"))
            cov, left, top = oracle.bitmap(gid, size)
            bm = raster.glyph_bitmap(face, size, gid)
            drawn = (bm.coverage.shape == cov.shape
                     and (bm.coverage == cov).all()
                     and (not cov.size or (bm.left, bm.top) == (left, top)))
            bitmaps_ok += drawn
            if not drawn:
                parted.append((size, gid, "bitmap"))
    return {"pairs": pairs, "points": points_ok, "bitmaps": bitmaps_ok,
            "parted": parted}


def ink_digest(mask: np.ndarray, offset) -> str:
    """SHA-256 of what a text mask inks: its nonzero box (rows, columns,
    place relative to the text's ``xy``) and that box's bytes, rows top
    down; PIL's masks and the port's frame the ink differently."""
    rows, cols = np.nonzero(mask)
    if not len(rows):
        return hashlib.sha256(b"empty").hexdigest()
    y0, y1, x0, x1 = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
    head = (f"{y1 - y0} {x1 - x0} {offset[0] + x0} {offset[1] + y0}\n"
            .encode())
    return hashlib.sha256(
        head + np.ascontiguousarray(mask[y0:y1, x0:x1]).tobytes()).hexdigest()


def pillow_digests(chars: str, sizes=DIGEST_SIZES) -> Dict[str, List[str]]:
    """``ink_digest`` of PIL's ``getmask2`` of each character, by size."""
    from PIL import Image, ImageFont

    out = {}
    for size in sizes:
        font = ImageFont.truetype(FONT, size)
        digests = []
        for ch in chars:
            core, offset = font.getmask2(ch, mode="L", anchor="la")
            digests.append(ink_digest(np.asarray(Image.Image()._new(core)),
                                      offset))
        out[str(size)] = digests
    return out


def port_digests(chars: str, sizes=DIGEST_SIZES) -> Dict[str, List[str]]:
    """``ink_digest`` of the port's ``Font.getmask`` of each character."""
    from marconet_tpu_torch.utils.text_draw import truetype

    return {str(size): [ink_digest(*truetype(FONT, size).getmask(ch))
                        for ch in chars] for size in sizes}


def write_digests(path=DIGESTS) -> None:
    from PIL import __version__ as pillow_version
    from PIL import features

    from marconet_tpu_torch.utils.truetype import TrueTypeFace

    chars = "".join(ch for _, ch in alphabet_glyphs(TrueTypeFace(FONT)))
    fixture = {
        "font": "fonts/DejaVuSans.ttf",
        "made_with": f"Pillow {pillow_version}, FreeType "
                     f"{features.version('freetype2')}",
        "digest": "tests/torch_render_report.py::ink_digest of "
                  "ImageFont.getmask2(char, mode='L', anchor='la')",
        "chars": chars, "digests": pillow_digests(chars)}
    with open(path, "w") as f:
        json.dump(fixture, f, indent=0, ensure_ascii=False)
        f.write("\n")
    print(f"wrote {path}: {len(chars)} glyphs at {DIGEST_SIZES} px")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=1000)
    parser.add_argument("--timed", type=int, default=40)
    parser.add_argument("--write-digests", action="store_true")
    args = parser.parse_args()
    if args.write_digests:
        write_digests()
    print(summary(compare_renders(args.seeds)))
    t = time_renders(args.timed)
    print(f"render time over {args.timed} seeds: PIL {t['pil_ms']:.2f} ms, "
          f"port {t['port_ms']:.2f} ms a line, ratio {t['ratio']:.3f}")
    sw = sweep()
    print(f"glyph sweep, {len(SWEEP_SIZES)} sizes x "
          f"{sw['pairs'] // len(SWEEP_SIZES)} glyphs = {sw['pairs']} pairs: "
          f"points exact on {sw['points']} "
          f"({100 * sw['points'] / sw['pairs']:.2f}%), bitmaps exact on "
          f"{sw['bitmaps']} ({100 * sw['bitmaps'] / sw['pairs']:.2f}%)")
    for size, gid, what in sw["parted"]:
        print(f"  parts at {size} px, glyph {gid}: {what}")


if __name__ == "__main__":
    main()
