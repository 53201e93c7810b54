"""The port's GIF writer (``marconet_tpu_torch.utils.gif``), as PIL reads
it back, against ``imageio.mimsave`` (the JAX ``test_w``'s writer).

``test_w``'s 11 style blends are written with a 10-hundredths delay and a
NETSCAPE2.0 loop; PIL must read 11 frames, each of 100 ms, looping
forever, and each frame exactly as the writer's own palette and indices
give it (the LZW stream is lossless). The palette is lossy: on the same
seeded blends the decoded frames' mean absolute error may be at most
1.25x that of ``imageio.mimsave(..., "GIF", duration=0.1)`` plus 0.5
levels. Measured on ``_blends()``: 2.235 levels for the port, 2.390 for
imageio.
"""

import io

import imageio
import numpy as np
import pytest
from PIL import Image

from marconet_tpu_torch.utils.gif import encode_gif, quantize, write_gif

STEPS = 11


def _blends(n_chars: int = 4, seed: int = 0) -> list:
    """11 blends of two seeded 'glyph rows' (128 x 128 n), as test_w
    writes them."""
    rng = np.random.default_rng(seed)
    h, w = 128, 128 * n_chars
    y, x = np.mgrid[0:h, 0:w]
    ink = ((np.sin(x / 9.0) * np.cos(y / 7.0)) > 0.3)[..., None]
    a = np.where(ink, rng.uniform(0, 90, 3), rng.uniform(150, 255, 3))
    b = np.where(ink[::-1], rng.uniform(0, 90, 3), rng.uniform(150, 255, 3))
    a = a + rng.normal(0, 12, a.shape)
    b = b + rng.normal(0, 12, b.shape)
    return [np.clip(a * (1 - t) + b * t, 0, 255).astype(np.uint8)
            for t in np.linspace(0, 1, STEPS)]


def _read(data: bytes):
    im = Image.open(io.BytesIO(data))
    frames, delays = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        delays.append(im.info.get("duration"))
    return frames, delays, im.info.get("loop")


def _mean_error(decoded, frames) -> float:
    return float(np.mean([np.abs(d.astype(int) - f).mean()
                          for d, f in zip(decoded, frames)]))


def test_test_w_animation(tmp_path):
    frames = _blends()
    path = tmp_path / "w.gif"
    write_gif(str(path), frames, delay_cs=10, loop=0)
    data = path.read_bytes()
    assert data.startswith(b"GIF89a") and data.endswith(b"\x3b")
    assert data.count(b"NETSCAPE2.0") == 1
    decoded, delays, loop = _read(data)
    assert len(decoded) == STEPS and delays == [100] * STEPS and loop == 0
    for got, frame in zip(decoded, frames):
        palette, idx = quantize(frame)
        np.testing.assert_array_equal(got, palette[idx])

    b = io.BytesIO()
    imageio.mimsave(b, frames, "GIF", duration=0.1)
    ours, theirs = _mean_error(decoded, frames), \
        _mean_error(_read(b.getvalue())[0], frames)
    assert ours <= 1.25 * theirs + 0.5, (ours, theirs)


@pytest.mark.parametrize("case", ["one_pixel", "two_colours", "256_colours",
                                  "noise", "wide_noise"])
def test_lossless_where_the_palette_is(case):
    """Frames of at most 256 colours come back exactly; noise frames whose
    LZW table fills (4096 codes) and restarts come back as their palette
    and indices give them."""
    rng = np.random.default_rng(len(case))
    shape = {"one_pixel": (1, 1), "two_colours": (5, 7),
             "256_colours": (16, 16), "noise": (64, 96),
             "wide_noise": (128, 1024)}[case]
    if case == "two_colours":
        frame = np.where(rng.random(shape + (1,)) < 0.5, [0, 0, 0],
                         [255, 10, 3]).astype(np.uint8)
    elif case == "256_colours":
        frame = rng.permutation(np.stack(np.unravel_index(
            np.arange(256), (8, 8, 4)), -1) * [32, 32, 64]) \
            .reshape(16, 16, 3).astype(np.uint8)
    else:
        frame = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    decoded, delays, loop = _read(encode_gif([frame, frame[::-1]], 7, 3))
    assert delays == [70, 70] and loop == 3
    for got, f in zip(decoded, [frame, frame[::-1]]):
        if case in ("one_pixel", "two_colours", "256_colours"):
            np.testing.assert_array_equal(got, f)
        else:
            palette, idx = quantize(f)
            assert len(palette) == 256
            np.testing.assert_array_equal(got, palette[idx])


def test_refuses_frames_of_another_size():
    with pytest.raises(ValueError, match="uint8"):
        encode_gif([np.zeros((4, 4, 3), np.uint8),
                    np.zeros((4, 5, 3), np.uint8)])
