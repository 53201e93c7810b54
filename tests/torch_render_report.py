"""The port's text-line render (``marconet_tpu_torch/utils/truetype.py``,
``raster.py``, ``text_draw.py`` under ``TextLineSynthesizer.render``)
against the JAX package's (PIL, FreeType, RAQM), on the fixture font
``tests/data/fonts/DejaVuSans.ttf``::

    python -m tests.torch_render_report [--seeds 1000] [--timed 40]

prints, over ``--seeds`` seeds on one flat background, how often both
renders leave the generator in the same state (and agree on
None-or-not), how far ``char_locs`` lie apart, and the IoU of the ink
masks; then the mean host milliseconds a render of each over ``--timed``
seeds, interleaved in one process so both see the same machine, each
side starting with cold caches (its font parsed and its glyphs
rasterized inside the timed renders, as in a fresh data worker).
``tests/test_torch_render.py`` holds 200 seeds and the 40 timed ones to
its tolerances.
"""

from __future__ import annotations

import argparse
import pathlib
import time
from typing import Dict

import numpy as np

FONT_DIR = str(pathlib.Path(__file__).parent / "data" / "fonts")


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
    equal generator states and are both None or both drawn), ``locs``
    (the largest ``char_locs`` distance of each seed both drew), ``iou``
    (of the ink masks over their common width, same seeds), ``texts``
    (whether text and labels were equal on every seed both drew)."""
    jax_synth, port_synth, bg = _synths()
    agree, locs, ious, texts = 0, [], [], True
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
    return {"seeds": seeds, "agree": agree, "locs": np.array(locs),
            "iou": np.array(ious), "texts": texts}


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
            f"px); mask IoU min {iou.min():.4f} mean {iou.mean():.4f}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=1000)
    parser.add_argument("--timed", type=int, default=40)
    args = parser.parse_args()
    print(summary(compare_renders(args.seeds)))
    t = time_renders(args.timed)
    print(f"render time over {args.timed} seeds: PIL {t['pil_ms']:.2f} ms, "
          f"port {t['port_ms']:.2f} ms a line, ratio {t['ratio']:.3f}")


if __name__ == "__main__":
    main()
